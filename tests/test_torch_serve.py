"""Port parity: ``core.progressive`` and the progressive server.

The cases of the JAX package's ``tests/test_progressive_serving.py``
(``LayeredLinear``, the resolution series, two-sided layering, and the
server's budget and deadline modes, the latter on the ``thread`` runtime
backend), run on the port; the JAX package's own server runs beside it on
the same weights (carried with ``models.convert``), and the port's greedy
tokens at full budget must equal the JAX server's.

Then the step the server captures in a CUDA graph on the card, run here
eagerly: ``hidden_step`` at a 0-d tensor position gives bit-equal hidden
states and caches to the int position over four chained steps for a
smoke config of each family (the hybrid's prompt a multiple of its
window, where the reference's ring is right, ROADMAP R6), whose logits
match the reference's ``decode_step`` at fp32 within 1e-4 (absolute and
relative, as ``test_torch_models.py``); and the server's step on static
buffers updated in place gives ``ProgressiveServer.decode``'s tokens,
caches and stats.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.configs.base import ModelConfig as JModel  # noqa: E402
from repro.core import progressive as jprog  # noqa: E402
from repro.launch.serve import ProgressiveServer as JServer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import AttentionConfig, ModelConfig  # noqa
from repro_torch.core import progressive  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import ProgressiveServer  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


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


# ---------------------------------------------------------------------------
# The captured step, run eagerly
# ---------------------------------------------------------------------------

#: one smoke config per family
FAMILIES = {"dense": "llama3-8b", "ssm": "mamba2-370m",
            "hybrid": "recurrentgemma-9b", "moe": "qwen2-moe-a2.7b",
            "audio": "whisper-tiny", "vlm": "internvl2-1b"}
#: batch, prompt (a multiple of the hybrid's window of 8), decode steps
_B, _S, _STEPS = 2, 16, 4


def _family_case(family, dtype):
    """A family's smoke config in both packages at ``dtype``, the JAX
    package's parameters carried over, seeded tokens and extras."""
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               compute_dtype=dtype)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              compute_dtype=dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (_B, _S + _STEPS)).astype(np.int32)
    extras = {}
    if cfg.is_encdec:
        extras["audio_embeds"] = rng.normal(
            size=(_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        extras["extra_embeds"] = rng.normal(
            size=(_B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return cfg, params, (jcfg, jparams), toks, extras


def _clone(tree):
    return [_clone(x) for x in tree] if isinstance(tree, (list, tuple)) \
        else {k: _clone(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.clone()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tensor_position_steps_equal_int_position_steps(family, dtype):
    cfg, params, (jcfg, jparams), toks, extras = _family_case(family, dtype)
    tt = torch.from_numpy(toks).long()
    tkw = {k: torch.from_numpy(v) for k, v in extras.items()}
    _, by_int = T.prefill(params, tt[:, :_S], cfg, max_len=_S + _STEPS,
                          **tkw)
    by_tensor = _clone(by_int)
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg))
    _, jcaches = jax.jit(lambda p, t, e: JT.prefill(
        p, t, jcfg, _S + _STEPS, **e))(
        jparams, jnp.asarray(toks[:, :_S]),
        {k: jnp.asarray(v) for k, v in extras.items()})
    for i in range(_STEPS):
        tok = tt[:, _S + i:_S + i + 1]
        want, _ = T.hidden_step(params, tok, by_int, _S + i, cfg)
        pos = torch.tensor(_S + i, dtype=torch.int64)
        got, _ = T.hidden_step(params, tok, by_tensor, pos, cfg)
        assert torch.equal(got, want), f"step {i}"
        assert pos.item() == _S + i            # read, never advanced
        for a, b in zip(leaves(by_tensor), leaves(by_int)):
            assert torch.equal(a, b), f"caches after step {i}"
        jlogits, jcaches = jdecode(jparams, jnp.asarray(toks[:, _S + i:
                                                             _S + i + 1]),
                                   jcaches, jnp.int32(_S + i))
        if dtype == "float32":
            np.testing.assert_allclose(
                T._head(params, got, cfg).numpy(), np.asarray(jlogits),
                atol=1e-4, rtol=1e-4, err_msg=f"decode step {i}")


def test_tensor_position_must_be_a_0d_int64():
    cfg, params, _, toks, _ = _family_case("dense", "float32")
    tt = torch.from_numpy(toks).long()
    _, caches = T.prefill(params, tt[:, :_S], cfg, max_len=_S + _STEPS)
    for bad in (torch.tensor([_S]), torch.tensor(_S, dtype=torch.int32)):
        with pytest.raises(TypeError, match="0-d int64"):
            T.hidden_step(params, tt[:, _S:_S + 1], caches, bad, cfg)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_a_write_past_the_caches_raises(as_tensor):
    """A step at a position past the attention caches raises
    ``IndexError`` at an int position as at a tensor position (there the
    ``index_copy_``'s own bound check; on the card a device-side assert,
    which ``decode`` forestalls on the host)."""
    cfg, params, _, toks, _ = _family_case("dense", "float32")
    tt = torch.from_numpy(toks).long()
    _, caches = T.prefill(params, tt[:, :_S], cfg, max_len=_S + 1)
    T.hidden_step(params, tt[:, _S:_S + 1], caches, _S, cfg)   # the last
    pos = torch.tensor(_S + 1) if as_tensor else _S + 1
    with pytest.raises(IndexError, match="out of bounds"):
        T.hidden_step(params, tt[:, _S:_S + 1], caches, pos, cfg)


@pytest.mark.parametrize("family", ["dense", "audio"])
def test_decode_past_the_caches_raises_before_a_step(family):
    cfg, params, _, toks, extras = _family_case(family, "float32")
    tt = torch.from_numpy(toks).long()
    tkw = {k: torch.from_numpy(v) for k, v in extras.items()}
    server = ProgressiveServer(cfg, params, device="cpu")
    _, caches = server.prefill(tt[:, :_S], _S + _STEPS, **tkw)
    before = _clone(caches)
    with pytest.raises(ValueError, match="overrun caches of 20 positions"):
        server.decode(tt[:, _S - 1:_S], caches, _S, _STEPS + 1)
    for a, b in zip(leaves(caches), leaves(before)):
        assert torch.equal(a, b)
    out, _ = server.decode(tt[:, _S - 1:_S], caches, _S, _STEPS)
    assert out.shape == (_B, _STEPS)


def test_captured_steps_are_keyed_by_the_caches_shape():
    """Two prompts' caches of one shape share a captured step (as
    ``jax.jit`` compiles once per shape); another length or batch does
    not."""
    cfg, params, _, toks, _ = _family_case("dense", "float32")
    tt = torch.from_numpy(toks).long()
    first = T.prefill(params, tt[:, :_S], cfg, max_len=_S + _STEPS)[1]
    second = T.prefill(params, tt[:, 1:_S + 1], cfg, max_len=_S + _STEPS)[1]
    assert leaves(first)[0].data_ptr() != leaves(second)[0].data_ptr()
    assert serve._shape_key(first) == serve._shape_key(second)
    for other in (T.prefill(params, tt[:, :_S], cfg,
                            max_len=_S + _STEPS + 1)[1],
                  T.init_cache(cfg, _B + 1, _S + _STEPS, device="cpu")):
        assert serve._shape_key(first) != serve._shape_key(other)


@pytest.mark.parametrize("budget", [None, 1])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_captured_step_run_eagerly_equals_decode(family, budget):
    """``ProgressiveServer._step`` (what the card server captures), run
    eagerly on static buffers updated in place, gives ``decode``'s tokens,
    caches and stats."""
    cfg, params, _, toks, extras = _family_case(family, "float32")
    tt = torch.from_numpy(toks).long()
    tkw = {k: torch.from_numpy(v) for k, v in extras.items()}
    server = ProgressiveServer(cfg, params, device="cpu")
    assert not server.graphs
    _, caches = server.prefill(tt[:, :_S], _S + _STEPS, **tkw)
    static_caches = _clone(caches)
    want, stats = server.decode(tt[:, _S - 1:_S], caches, _S, _STEPS,
                                layer_budget=budget)
    release = server.m if budget is None else budget
    tok, pos = tt[:, _S - 1:_S].clone(), torch.tensor(_S)
    got = []
    with torch.no_grad():
        for _ in range(_STEPS):
            logits = server._step(tok, pos, static_caches, release)
            assert logits.shape == (_B, cfg.vocab_size)
            got.append(tok.clone())
    assert torch.equal(torch.cat(got, dim=1), want)
    assert pos.item() == _S + _STEPS
    for a, b in zip(leaves(static_caches), leaves(caches)):
        assert torch.equal(a, b)
    assert stats.steps == _STEPS
    assert stats.released_at_layer == [release] * _STEPS
    assert stats.full_resolution == (_STEPS if release == server.m else 0)


def test_graphs_need_a_card_server():
    """``graphs`` defaults to off on the CPU, and asking for it there
    raises."""
    cfg = ModelConfig(**_CFG, attention=AttentionConfig(**_ATTN))
    params = T.init_params(cfg, device="cpu")
    assert not ProgressiveServer(cfg, params, device="cpu").graphs
    assert not ProgressiveServer(cfg, params, device="cpu",
                                 graphs=False).graphs
    with pytest.raises(ValueError, match="graphs=True needs a card"):
        ProgressiveServer(cfg, params, device="cpu", graphs=True)
