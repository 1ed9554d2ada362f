"""Port parity: ``core.progressive`` and the progressive server.

The cases of the JAX package's ``tests/test_progressive_serving.py``
(``LayeredLinear``, the resolution series, two-sided layering, and the
server's budget and deadline modes, the latter on the ``thread`` runtime
backend), run on the port; the JAX package's own server runs beside it on
the same weights (carried with ``models.convert``), and the port's greedy
tokens at full budget must equal the JAX server's.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.configs.base import ModelConfig as JModel  # noqa: E402
from repro.core import progressive as jprog  # noqa: E402
from repro.launch.serve import ProgressiveServer as JServer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import AttentionConfig, ModelConfig  # noqa
from repro_torch.core import progressive  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import ProgressiveServer  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _f(a):
    return torch.from_numpy(np.asarray(a, np.float32))


class TestLayeredLinear:
    def test_full_resolution_equals_quantized_product(self, rng):
        W = _f(rng.normal(size=(32, 16)))
        x = _f(rng.normal(size=(4, 32)))
        ll = progressive.make_layered_linear(W, m=3, d=5)
        full = progressive.layered_linear_apply(ll, x)
        # error bounded by quantization, not layering
        err = (full - x @ W).abs().max().item()
        assert err < 0.05 * (x @ W).abs().max().item() + 1e-3

    def test_series_monotone_and_last_equals_full(self, rng):
        W = _f(rng.normal(size=(16, 8)))
        x = _f(rng.normal(size=(3, 16)))
        ll = progressive.make_layered_linear(W, m=4, d=4)
        series = progressive.resolution_series(ll, x)
        assert series.shape[0] == 4
        full = x @ W
        errs = [(series[l] - full).abs().max().item() for l in range(4)]
        assert all(a >= b for a, b in zip(errs, errs[1:])), errs
        torch.testing.assert_close(
            series[-1], progressive.layered_linear_apply(ll, x), rtol=1e-5,
            atol=1e-5)

    def test_two_sided_layering_num_layers(self, rng):
        x = _f(rng.normal(size=(3, 8)))
        W = _f(rng.normal(size=(8, 6)))
        out = progressive.two_sided_layered_matmul(x, W, m=3, d=5)
        assert out.shape == (5, 3, 6)  # L = 2m-1
        errs = [(out[l] - x @ W).abs().max().item() for l in range(5)]
        assert errs[0] >= errs[-1]

    def test_resolution_out_of_range(self):
        ll = progressive.make_layered_linear(torch.eye(4), m=2, d=4)
        with pytest.raises(ValueError):
            progressive.layered_linear_apply(ll, torch.ones((1, 4)),
                                             resolution=5)

    @pytest.mark.parametrize("m,d", [(2, 7), (3, 5), (2, 8)])
    def test_planes_and_series_match_jax(self, rng, m, d):
        W = rng.normal(size=(24, 40)).astype(np.float32)
        x = rng.normal(size=(5, 24)).astype(np.float32)
        jll = jprog.make_layered_linear(jnp.asarray(W), m=m, d=d)
        tll = progressive.make_layered_linear(torch.from_numpy(W), m=m, d=d)
        assert tll.planes.dtype == (torch.int8 if d <= 7 else torch.int16)
        np.testing.assert_array_equal(tll.planes.numpy(),
                                      np.asarray(jll.planes))
        assert tll.scale.item() == float(jll.scale)
        np.testing.assert_allclose(
            progressive.resolution_series(tll, torch.from_numpy(x)).numpy(),
            np.asarray(jprog.resolution_series(jll, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            progressive.layered_lm_head(tll, torch.from_numpy(x), 0).numpy(),
            np.asarray(jprog.layered_lm_head(jll, jnp.asarray(x), 0)),
            rtol=1e-5, atol=1e-5)

    def test_two_sided_matches_jax(self, rng):
        x = rng.normal(size=(3, 8)).astype(np.float32)
        W = rng.normal(size=(8, 6)).astype(np.float32)
        got = progressive.two_sided_layered_matmul(
            torch.from_numpy(x), torch.from_numpy(W), m=3, d=5)
        want = jprog.two_sided_layered_matmul(jnp.asarray(x), jnp.asarray(W),
                                              m=3, d=5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


_CFG = dict(name="t", family="dense", num_layers=2, d_model=32, d_ff=64,
            vocab_size=128, compute_dtype="float32")
_ATTN = dict(num_heads=2, num_kv_heads=1, head_dim=16)


class TestProgressiveServer:
    def _setup(self, rng):
        jcfg = JModel(**_CFG, attention=JAttn(**_ATTN))
        cfg = ModelConfig(**_CFG, attention=AttentionConfig(**_ATTN))
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        params = convert.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
        server = ProgressiveServer(cfg, params, m=3, d=5, device="cpu")
        toks = rng.integers(0, 128, (2, 8)).astype(np.int32)
        return (cfg, params, server, torch.from_numpy(toks).long(),
                (jcfg, jparams, toks))

    def test_full_budget_matches_reference_decode(self, rng):
        cfg, params, server, toks, _ = self._setup(rng)
        _, caches = server.prefill(toks, max_len=16)
        out, stats = server.decode(toks[:, -1:], caches, 8, 4)
        assert out.shape == (2, 4)
        assert stats.full_resolution == stats.steps == 4
        # against plain greedy decode (argmax can differ only when the
        # top-2 logits are within the quantization error)
        _, caches2 = T.prefill(params, toks, cfg, max_len=16)
        tok = toks[:, -1:]
        agree = 0
        for i in range(4):
            logits, caches2 = T.decode_step(params, tok, caches2, 8 + i, cfg)
            tok = torch.argmax(logits, -1)[:, None]
            agree += int(bool((tok[:, 0] == out[:, i]).all()))
        assert agree >= 3

    @pytest.mark.parametrize("budget", [None, 1, 2])
    def test_greedy_tokens_equal_the_jax_servers(self, rng, budget):
        """Same weights, same prompt: the port's greedy tokens are the JAX
        server's, at full budget and below it."""
        cfg, params, server, toks, (jcfg, jparams, jtoks) = self._setup(rng)
        jserver = JServer(jcfg, jparams, m=3, d=5)
        _, jc = jserver.prefill(jnp.asarray(jtoks), max_len=16)
        want, jstats = jserver.decode(jnp.asarray(jtoks[:, -1:]), jc, 8, 6,
                                      layer_budget=budget)
        _, caches = server.prefill(toks, max_len=16)
        got, stats = server.decode(toks[:, -1:], caches, 8, 6,
                                   layer_budget=budget)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats.released_at_layer == jstats.released_at_layer

    def test_budget_one_still_generates(self, rng):
        _, _, server, toks, _ = self._setup(rng)
        _, caches = server.prefill(toks, max_len=16)
        out, stats = server.decode(toks[:, -1:], caches, 8, 4,
                                   layer_budget=1)
        assert out.shape == (2, 4)
        assert stats.full_resolution == 0
        assert all(r == 1 for r in stats.released_at_layer)

    def test_deadline_ms_bounds_compute(self, rng):
        """The wall-clock deadline path runs each head step as a runtime
        job (``thread`` backend, the server being on the CPU): an expired
        deadline releases only resolution 0, a generous one the full
        ``L = 2m - 1`` and agrees with the non-deadline decode up to
        two-sided quantization."""
        _, _, server, toks, _ = self._setup(rng)
        with server:
            _, caches = server.prefill(toks, max_len=16)
            out, stats = server.decode(toks[:, -1:], caches, 8, 4,
                                       deadline_ms=0.0)
            assert out.shape == (2, 4)
            assert stats.resolutions == 2 * server.m - 1
            assert stats.released_at_layer == [1] * 4
            assert stats.full_resolution == 0
            assert len(stats.head_service_seconds) == 4
            backends = {h.gateway.cfg.backend
                        for h in server._runtime_heads.values()}
            assert backends == {"thread"}

            _, caches = server.prefill(toks, max_len=16)
            out_full, stats_full = server.decode(toks[:, -1:], caches, 8, 4,
                                                 deadline_ms=1e9)
            assert stats_full.released_at_layer == [2 * server.m - 1] * 4
            assert stats_full.full_resolution == 4
            _, caches = server.prefill(toks, max_len=16)
            out_ref, _ = server.decode(toks[:, -1:], caches, 8, 4)
            agree = int((out_full == out_ref).float().mean().item() * 8)
            assert agree >= 6, (out_full, out_ref)
        assert server._runtime_heads == {}

    def test_deeper_budget_closer_to_full(self, rng):
        _, _, server, toks, _ = self._setup(rng)
        _, c0 = server.prefill(toks, max_len=32)
        full, _ = server.decode(toks[:, -1:], c0, 8, 8)
        agreements = []
        for budget in (1, 2, 3):
            _, c = server.prefill(toks, max_len=32)
            out, _ = server.decode(toks[:, -1:], c, 8, 8,
                                   layer_budget=budget)
            agreements.append((out == full).float().mean().item())
        assert agreements[-1] >= agreements[0]

    def test_budgets_are_exclusive(self, rng):
        _, _, server, toks, _ = self._setup(rng)
        _, c = server.prefill(toks, max_len=16)
        with pytest.raises(ValueError, match="mutually exclusive"):
            server.decode(toks[:, -1:], c, 8, 2, layer_budget=1,
                          deadline_ms=5.0)


def test_server_defaults_to_cuda(monkeypatch):
    """The server runs on the card unless the caller asks for the CPU:
    without a GPU the default raises, and parameters on another device
    than the one asked for are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**_CFG, attention=AttentionConfig(**_ATTN))
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressiveServer(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    server = ProgressiveServer(cfg, params, device="cpu")
    assert server.device.type == "cpu" and server._backend == "thread"
    with pytest.raises(ValueError, match="asked for"):
        ProgressiveServer(cfg, params, device="meta")


@pytest.mark.parametrize("arch", [
    "llama3-8b-smoke", "mamba2-370m-smoke", "yi-6b-smoke", "glm4-9b-smoke",
    "starcoder2-7b-smoke", "recurrentgemma-9b-smoke", "qwen2-moe-a2.7b-smoke",
    "llama4-maverick-400b-a17b-smoke"])
def test_main_serves_smoke_arch_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "3/3 steps at full resolution (of 2)" in out


def test_stats_defaults_are_independent():
    a, b = serve.ServeStats(), serve.ServeStats()
    a.released_at_layer.append(1)
    assert b.released_at_layer == [] and dataclasses.is_dataclass(a)
