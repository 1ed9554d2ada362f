"""Port parity: the encoder-decoder (whisper-tiny) and vision-language
(internvl2-1b) families on the serving path.

The JAX package's parameters are carried into the port with
``models.convert``, and both packages run the same tokens and the same
stub frontend inputs (frame embeddings ``audio_embeds`` for the
encoder-decoder, patch embeddings ``extra_embeds`` for the vlm config),
made with NumPy from one seed; ``repro.models.transformer`` is called
directly, with no ambient mesh.  Forward logits, prefill last logits and
every cache (the encoder's cross-attention K/V among them), and four
chained decode steps must agree at the tolerances of
``test_torch_models.py``: fp32 1e-4 absolute and relative, bf16 2e-2 of
the largest value.

The configs are the ``audio`` and ``vlm`` configs of ``test_models.py``
(fp32, as there) and the whisper-tiny and internvl2-1b smoke configs in
fp32 and in their own bf16.  Then, within the port: decode against
forward, the server's greedy tokens against the JAX server's, and the
serving CLI on both smoke archs.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_models import CONFIGS as JAX_TEST_CONFIGS  # noqa: E402
from test_torch_models import DECODE, _close  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.serve import ProgressiveServer as JServer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import ProgressiveServer  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

B, S = 2, 16
#: (case, compute dtype): the test_models configs in their fp32, the
#: smoke configs in fp32 and in their own bf16
CASES = [("audio", "float32"), ("vlm", "float32"),
         ("whisper-tiny", "float32"), ("whisper-tiny", "bfloat16"),
         ("internvl2-1b", "float32"), ("internvl2-1b", "bfloat16")]


def port_config(jcfg):
    """The port's ModelConfig with every field of a JAX package config,
    and the port's own fields (which the JAX package lacks) at their
    defaults."""
    fields = {f.name: getattr(jcfg, f.name, f.default)
              for f in dataclasses.fields(tbase.ModelConfig)}
    if jcfg.attention is not None:
        fields["attention"] = tbase.AttentionConfig(
            **dataclasses.asdict(jcfg.attention))
    return tbase.ModelConfig(**fields)


def jax_config(case, dtype):
    jcfg = (JAX_TEST_CONFIGS[case] if case in JAX_TEST_CONFIGS
            else jreg.get_smoke_config(case))
    return dataclasses.replace(jcfg, compute_dtype=dtype)


def extras(cfg, batch, rng):
    """The stub frontend inputs of ``cfg`` as fp32 NumPy arrays."""
    kw = {}
    if cfg.is_encdec:
        kw["audio_embeds"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        kw["extra_embeds"] = rng.normal(
            size=(batch, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32)
    return kw


@functools.lru_cache(maxsize=None)
def _runs(case, dtype):
    """Both packages on the same weights, tokens and extras (cached)."""
    jcfg = jax_config(case, dtype)
    tcfg = port_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + DECODE)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    kw = extras(jcfg, B, rng)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    out = {"cfg": tcfg}
    jl, _ = jax.jit(lambda p, t, e: JT.forward(p, t, jcfg, **e))(
        jp, jnp.asarray(toks), jkw)
    tl, _ = TT.forward(tp, tt, tcfg, **tkw)
    out["forward"] = (tl, jl)
    jlast, jc = jax.jit(lambda p, t, e: JT.prefill(p, t, jcfg, S + DECODE,
                                                   **e))(
        jp, jnp.asarray(toks[:, :S]), jkw)
    tlast, tc = TT.prefill(tp, tt[:, :S], tcfg, max_len=S + DECODE, **tkw)
    out["prefill"] = (tlast, jlast)
    # every cache leaf, with its path (decode below updates the port's in
    # place, so they are copied here)
    out["caches"] = ([(path, t.clone())
                      for path, t in ttree.leaves_with_path(tc)],
                     [np.asarray(x) for x in jax.tree.leaves(jc)])
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg))
    steps = []
    for i in range(DECODE):
        jg, jc = jdecode(jp, jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                         jnp.int32(S + i))
        tg, tc = TT.decode_step(tp, tt[:, S + i:S + i + 1], tc, S + i, tcfg)
        steps.append((tg, jg))
    out["decode"] = steps
    return out


def _ids(case):
    return f"{case[0]}-{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_logits_match_jax(case):
    got, want = _runs(*case)["forward"]
    assert got.shape == want.shape
    _close(got, want, case[1], "forward logits")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_last_logits_and_caches_match_jax(case):
    """The last logits, the decoder's KV caches and, for the
    encoder-decoder, the per-layer encoder K/V (``enc_kvs``)."""
    runs = _runs(*case)
    got, want = runs["prefill"]
    _close(got, want, case[1], "prefill last logits")
    tcaches, jcaches = runs["caches"]
    assert len(tcaches) == len(jcaches)
    if runs["cfg"].is_encdec:
        # (caches, enc_kvs): the decoder's k and v, then the encoder's
        assert [p[0] for p, _ in tcaches] == [0, 0, 1, 1]
    for (path, t), j in zip(tcaches, jcaches):
        assert tuple(t.shape) == j.shape, path
        _close(t, j, case[1], f"cache {path}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chained_decode_steps_match_jax(case):
    for i, (got, want) in enumerate(_runs(*case)["decode"]):
        _close(got, want, case[1], f"decode step {i}")


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_decode_matches_forward(rng, arch):
    """Within the port: decode_step at S against forward over S + 1
    tokens (the JAX package's ``test_decode_matches_forward``, 2e-3 of
    the largest logit in fp32)."""
    cfg = dataclasses.replace(port_config(jreg.get_smoke_config(arch)),
                              compute_dtype="float32")
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + 1)))
    kw = {k: torch.from_numpy(v) for k, v in extras(cfg, 2, rng).items()}
    full, _ = TT.forward(params, toks, cfg, **kw)
    _, cache = TT.prefill(params, toks[:, :S], cfg, max_len=S + 8, **kw)
    got, _ = TT.decode_step(params, toks[:, S:], cache, S, cfg)
    want = full[:, -1]
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 2e-3, err


def test_encoder_runs_once_per_prefill(monkeypatch, rng):
    """The reference runs the encoder twice per prefill (in ``forward``,
    then again for the caches); the port once, with the same caches."""
    cfg = dataclasses.replace(port_config(jreg.get_smoke_config(
        "whisper-tiny")), compute_dtype="float32")
    params = TT.init_params(cfg, seed=0, device="cpu")
    calls = []
    real = TT._encoder_fwd
    monkeypatch.setattr(TT, "_encoder_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    audio = torch.from_numpy(extras(cfg, 2, rng)["audio_embeds"])
    _, (caches, enc_kvs) = TT.prefill(params, toks, cfg, max_len=S + 2,
                                      audio_embeds=audio)
    assert calls == [1]
    enc = real(params, audio, cfg)
    for (k, v), want in zip(enc_kvs, TT._enc_cross_kv(params, enc, cfg)):
        assert torch.equal(k, want[0]) and torch.equal(v, want[1])


def test_cross_attention_does_not_rope_q(monkeypatch, rng):
    """Rope runs on q and k of each self-attention only, encoder and
    decoder (the reference ropes only in its ``k_ext is None`` branch),
    and the forward equals the JAX package's."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("whisper-tiny"),
                               compute_dtype="float32")
    cfg = port_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    audio = extras(cfg, 1, rng)["audio_embeds"]
    want, _ = JT.forward(jp, jnp.asarray(toks), jcfg,
                         audio_embeds=jnp.asarray(audio))
    real_rope, calls = TT.L.rope, []
    monkeypatch.setattr(TT.L, "rope", lambda x, pos, theta: calls.append(
        tuple(x.shape)) or real_rope(x, pos, theta))
    got, _ = TT.forward(tp, torch.from_numpy(toks).long(), cfg,
                        audio_embeds=torch.from_numpy(audio))
    _close(got, want, "float32", "forward logits")
    assert len(calls) == 2 * (cfg.encoder_layers + cfg.num_layers)


def _server_setup(arch, rng):
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               compute_dtype="float32")
    cfg = port_config(jcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, jparams, cfg, params, toks, extras(cfg, 2, rng)


@pytest.mark.parametrize("budget", [None, 1])
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_greedy_tokens_equal_the_jax_servers(rng, arch, budget):
    """Same weights, prompt and stub inputs: the port's server (the
    encoder K/V riding in its caches through every step) greedily picks
    the JAX server's tokens."""
    jcfg, jparams, cfg, params, toks, kw = _server_setup(arch, rng)
    jserver = JServer(jcfg, jparams, m=2, d=7)
    _, jc = jserver.prefill(jnp.asarray(toks), max_len=20,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    want, jstats = jserver.decode(jnp.asarray(toks[:, -1:]), jc, 12, 6,
                                  layer_budget=budget)
    with ProgressiveServer(cfg, params, m=2, d=7, device="cpu") as server:
        _, caches = server.prefill(
            torch.from_numpy(toks).long(), max_len=20,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        got, stats = server.decode(torch.from_numpy(toks[:, -1:]).long(),
                                   caches, 12, 6, layer_budget=budget)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats.released_at_layer == jstats.released_at_layer


@pytest.mark.parametrize("arch", ["whisper-tiny-smoke", "internvl2-1b-smoke"])
def test_main_serves_smoke_arch_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen", "3"]) == 0
    assert "3/3 steps at full resolution (of 2)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_params_and_caches_match_jax_layout(arch):
    """Parameters (the encoder and the cross-attention among them) and
    zero caches: the same paths, shapes and dtypes as the JAX package's."""
    jcfg = jreg.get_smoke_config(arch)
    cfg = port_config(jcfg)
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tparams = TT.init_params(cfg, seed=0, device="cpu")
    jleaves = jax.tree.leaves(jshapes)
    tleaves = ttree.leaves_with_path(tparams)
    assert len(jleaves) == len(tleaves)
    for j, (path, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
    if cfg.is_encdec:
        assert {"encoder", "groups"} <= set(tparams)
        assert {"xattn", "ln_x"} <= set(tparams["groups"][0][0])
    jc = jax.tree.map(np.asarray, JT.init_cache(jcfg, 2, 12))
    tc = TT.init_cache(cfg, 2, 12, device="cpu")
    for j, t in zip(jax.tree.leaves(jc), ttree.leaves(tc)):
        assert tuple(t.shape) == j.shape and not t.any()
