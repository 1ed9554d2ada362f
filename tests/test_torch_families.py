"""Port parity: the dense, hybrid (RG-LRU + local attention) and MoE
families of the serving path.

The six smoke configs yi-6b, glm4-9b, starcoder2-7b, recurrentgemma-9b,
qwen2-moe-a2.7b and llama4-maverick-400b-a17b run through the harness of
``test_torch_models.py`` (the JAX package's parameters carried over with
``models.convert``, the same tokens, ``repro.models.transformer`` called
directly, with no ambient mesh): forward logits, prefill last logits and
every cache, and four chained decode steps, at the same tolerances, fp32
1e-4 absolute and relative and bf16 2e-2 of the largest value.

The MoE configs' router choices are compared before any output
(:func:`test_router_choices_match_jax`).  In bf16 two configs are not
held to 2e-2 of the JAX package's bf16 result, and are named; each is
held to 2e-2 plus the JAX package's own bf16 error, its bf16 result's
distance from its fp32 result (:func:`_close_bf16`):

* recurrentgemma-9b (five layers): the JAX package's bf16 result moves
  by 2.0-4.7 % of the largest value when only its GELU is computed in
  fp32 and rounded once, as PyTorch computes it
  (:func:`test_hybrid_bf16_reference_moves_with_one_rounding`), so a
  bf16 result that rounds at other places, the port's, cannot be held
  to 2e-2 of it.  Its own error is taken output by output.
* llama4-maverick-400b-a17b (top-1 of 8 experts): where two experts'
  logits are within a rounding of each other, the two packages may pick
  different ones, which changes that token's whole expert output and,
  through attention, every later token of its row.  Its outputs are
  compared only where every router call routed alike (:func:`_masks`).
  There too it is up to 2.5 % of the largest logit from the JAX
  package's bf16 result, and the JAX package's own bf16 forward is more
  than 2e-2 from its fp32 forward on the tokens that both of its runs
  route alike: that distance is its own error (:func:`_settled_error`).

Then, within the port, decode against forward, the zero caches' layout,
the local-attention ring at prompt lengths that are no multiple of the
window, and parameter counts from shapes alone.
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_models import B, DECODE, S, TOL, _close, _runs  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["yi-6b", "glm4-9b", "starcoder2-7b", "recurrentgemma-9b",
         "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
DTYPES = ["float32", "bfloat16"]
#: held in bf16 where the routing agrees (module docstring)
ROUTED = "llama4-maverick-400b-a17b"
#: held in bf16 against the reference's own rounding spread
HYBRID = "recurrentgemma-9b"


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _rel_where(a, b, mask=None):
    """max |a - b| / max |b|, both taken where ``mask`` (aligned with the
    leading dims) holds."""
    a, b = _np(a), _np(b)
    if mask is None:
        mask = np.ones(b.shape, bool)
    mask = np.broadcast_to(mask.reshape(mask.shape + (1,) * (
        b.ndim - mask.ndim)), b.shape)
    assert mask.any(), "no element routed alike"
    return float(np.abs(a - b)[mask].max() / (np.abs(b)[mask].max() + 1e-9))


def _close_bf16(got, want, own, what, mask=None):
    """The port's bf16 ``got`` within 2e-2 plus ``own``, the reference's
    own bf16 error, of the largest value of its bf16 ``want`` (where
    ``mask`` holds)."""
    err = _rel_where(got, want, mask)
    assert err <= TOL["bfloat16"] + own, (
        f"{what}: {err} of the largest value of the reference's bf16 "
        f"result, whose own error is {own}")


def _check(arch, dtype, key, got, want, what, mask=None):
    """``_close`` in fp32, and in bf16 for most archs; for the two that
    the module docstring names, :func:`_close_bf16` with the reference's
    own error: for the hybrid its bf16 ``want``'s distance from the fp32
    run's ``key`` entry (``key`` picks it out of ``_runs``), for llama4
    :func:`_settled_error`, where ``mask`` holds."""
    if dtype == "bfloat16" and arch == HYBRID:
        _close_bf16(got, want, _rel_where(want, key(_runs(arch,
                                                           "float32"))),
                    what)
    elif dtype == "bfloat16" and arch == ROUTED:
        _close_bf16(got, want, _settled_error(), what, mask)
    else:
        _close(got, want, dtype, what)


def _experts(calls, cfg):
    """Per router call ``(logits, idx (G, Tg, k))``, a ``(G Tg, E)`` bool:
    the experts that process each token, its top-k choices that its
    group's capacity kept, counted as ``moe_block`` counts them."""
    E, k, cf = (cfg.moe.num_experts, cfg.moe.top_k,
                cfg.moe.capacity_factor)
    out = []
    for _, idx in calls:
        G, Tg, _ = idx.shape
        capacity = max(math.ceil(Tg / E * k * cf), 2)
        onehot = np.eye(E, dtype=np.int64)[idx]               # (G,Tg,k,E)
        flat = onehot.reshape(G, Tg * k, E)
        pos = ((np.cumsum(flat, 1) - 1) * flat).sum(-1).reshape(G, Tg, k)
        out.append((onehot * (pos < capacity)[..., None]).any(2)
                   .reshape(G * Tg, E))
    return out


def _agreeing(calls, cfg):
    """``(B, T // B)`` bool: the tokens of one phase's router ``calls``
    (``(port, ref)``) that every call routed alike in both packages (the
    same experts kept) and whose row routed every earlier token alike, as
    attention carries an earlier token's output into later ones."""
    same = [(p == r).all(-1).reshape(B, -1)
            for p, r in zip(_experts(calls[0], cfg), _experts(calls[1], cfg))]
    return np.logical_and.accumulate(np.logical_and.reduce(same), axis=1)


def _settled_error():
    """llama4-maverick's own bf16 error: its bf16 forward logits' distance
    from its fp32 ones, on the tokens that the port's bf16 run and the
    reference's two runs all route alike."""
    r16, r32 = _runs(ROUTED, "bfloat16"), _runs(ROUTED, "float32")
    port, ref = r16["routes"]["forward"]
    alike = (_agreeing((port, ref), r16["cfg"])
             & _agreeing((ref, r32["routes"]["forward"][1]), r16["cfg"]))
    return _rel_where(r16["forward"][1], r32["forward"][1], alike)


def _decode_rows(runs):
    """``(B,)`` bool before each decode step and after the last: the rows
    whose prompt and earlier decode tokens were all routed alike."""
    rows = [_agreeing(runs["routes"]["prefill"], runs["cfg"])[:, -1]]
    for calls in runs["routes"]["decode"]:
        rows.append(rows[-1] & _agreeing(calls, runs["cfg"])[:, 0])
    return rows


def _masks(arch, dtype):
    """Where :func:`_check` compares llama4-maverick's bf16 outputs, per
    output of ``_runs``: forward ``(B, S + DECODE)``, prefill rows ``(B,)``,
    caches ``(B, max_len)`` and each decode step's rows; None else."""
    if not (dtype == "bfloat16" and arch == ROUTED):
        return dict.fromkeys(["forward", "prefill", "cache"],
                             None) | {"decode": [None] * DECODE}
    runs = _runs(arch, dtype)
    prefill = _agreeing(runs["routes"]["prefill"], runs["cfg"])   # (B, S)
    return {"forward": _agreeing(runs["routes"]["forward"], runs["cfg"]),
            "prefill": prefill[:, -1],
            "cache": np.concatenate(
                [prefill, np.repeat(prefill[:, -1:], DECODE, axis=1)], 1),
            "decode": _decode_rows(runs)[1:]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_choices_match_jax(arch, dtype):
    """Every router call of forward, prefill and the decode steps, before
    any output is compared.  fp32: the same experts, in the same order,
    as ``jax.lax.top_k`` picks them.  bf16: where a token's router input
    is the same up to rounding (every earlier call routed its row alike up
    to it), a choice may differ from the reference's only between experts
    whose logits in the reference are within 2e-2 of the token's largest
    |logit|."""
    runs = _runs(arch, dtype)
    routes, cfg = runs["routes"], runs["cfg"]
    # each phase's calls, with the rows whose router input starts clean
    phases = [(routes["forward"], np.ones(B, bool)),
              (routes["prefill"], np.ones(B, bool)),
              *zip(routes["decode"], _decode_rows(runs))]
    for (port, ref), rows in phases:
        assert len(port) == len(ref) > 0
        if dtype == "float32":
            for (_, pi), (_, ri) in zip(port, ref):
                np.testing.assert_array_equal(pi, ri)
            continue
        T = port[0][1].size // cfg.moe.top_k
        clean = np.repeat(rows[:, None], T // B, axis=1)          # (B, T/B)
        for (_, pi), (logits, ri), kp, kr in zip(
                port, ref, _experts(port, cfg), _experts(ref, cfg)):
            pi, ri = pi.reshape(T, -1), ri.reshape(T, -1)
            logits = logits.reshape(T, -1)
            for t in np.nonzero(clean.reshape(-1))[0]:
                only_ref = sorted(set(ri[t]) - set(pi[t]))
                only_port = sorted(set(pi[t]) - set(ri[t]))
                if only_ref:
                    gap = ((logits[t, only_ref].max()
                            - logits[t, only_port].min())
                           / np.abs(logits[t]).max())
                    assert gap <= TOL["bfloat16"], (t, only_ref, only_port,
                                                    gap)
            same = (kp == kr).all(-1).reshape(B, -1)
            clean &= np.logical_and.accumulate(same, axis=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, dtype):
    got, want = _runs(arch, dtype)["forward"]
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _check(arch, dtype, lambda r: r["forward"][1], got, want,
           "forward logits", _masks(arch, dtype)["forward"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits_and_caches_match_jax(arch, dtype):
    """S = 16 is a multiple of the hybrid smoke config's window (8), where
    the port's local-attention ring is the JAX package's layout."""
    runs, masks = _runs(arch, dtype), _masks(arch, dtype)
    got, want = runs["prefill"]
    _check(arch, dtype, lambda r: r["prefill"][1], got, want,
           "prefill last logits", masks["prefill"])
    # a stacked cache is (repeats, B, max_len, ...)
    cache_mask = None if masks["cache"] is None else masks["cache"][None]
    tcaches, jcaches = runs["caches"]
    assert len(tcaches) == len(jcaches)
    for u, (tcache, jcache) in enumerate(zip(tcaches, jcaches)):
        assert set(tcache) == set(jcache)
        for name in tcache:
            assert tuple(tcache[name].shape) == jcache[name].shape, name
            if name == "pos":
                np.testing.assert_array_equal(tcache[name].numpy(),
                                              jcache[name])
            else:
                _check(arch, dtype,
                       lambda r, u=u, n=name: r["caches"][1][u][n],
                       tcache[name], jcache[name], f"cache {u} {name}",
                       cache_mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_decode_steps_match_jax(arch, dtype):
    masks = _masks(arch, dtype)["decode"]
    for i, (got, want) in enumerate(_runs(arch, dtype)["decode"]):
        _check(arch, dtype, lambda r, i=i: r["decode"][i][1], got, want,
               f"decode step {i}", masks[i])


def _reference_moves_with_one_rounding():
    """The JAX package's bf16 hybrid smoke run again with only its GELU
    computed in fp32 and rounded to bf16 once, as PyTorch computes it:
    each output's distance from the unchanged run (forward logits,
    prefill last logits, four decode steps), of the largest value."""
    cfg = dataclasses.replace(jreg.get_smoke_config(HYBRID),
                              compute_dtype="bfloat16")
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + DECODE)).astype(np.int32))
    gelu = jax.nn.gelu
    jax.nn.gelu = lambda x, approximate=True: gelu(
        x.astype(jnp.float32), approximate=approximate).astype(x.dtype)
    try:       # traced here, as closures of their own, with that GELU
        out = [jax.jit(lambda p, t: JT.forward(p, t, cfg))(params, toks)[0]]
        last, cache = jax.jit(lambda p, t: JT.prefill(p, t, cfg, S + DECODE))(
            params, toks[:, :S])
        out.append(last)
        step = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, cfg))
        for i in range(DECODE):
            logits, cache = step(params, toks[:, S + i:S + i + 1], cache,
                                 jnp.int32(S + i))
            out.append(logits)
    finally:
        jax.nn.gelu = gelu
    runs = _runs(HYBRID, "bfloat16")
    want = ([runs["forward"][1], runs["prefill"][1]]
            + [w for _, w in runs["decode"]])
    return [_rel_where(o, w) for o, w in zip(out, want)]


def test_hybrid_bf16_reference_moves_with_one_rounding():
    """The witness for the hybrid's bf16 budget (module docstring): one
    change of where the JAX package rounds moves its own bf16 result by
    more than 2e-2 of the largest value (and by less than 0.1)."""
    moved = _reference_moves_with_one_rounding()
    assert TOL["bfloat16"] < max(moved) < 0.1, moved


def test_llama4_bf16_reference_error_where_routed_alike():
    """The witness for llama4-maverick's bf16 budget (module docstring):
    where no run's routing differs, the JAX package's own bf16 forward is
    more than 2e-2 of the largest value from its fp32 forward (and less
    than 0.1)."""
    assert TOL["bfloat16"] < _settled_error() < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(rng, arch):
    """Within the port, in fp32: decode_step at S against forward over
    S + 1 tokens (the MoE configs at a lossless capacity)."""
    cfg = TM.lossless_capacity(dataclasses.replace(
        treg.get_smoke_config(arch), compute_dtype="float32"))
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    full, _ = TT.forward(params, toks, cfg)
    _, cache = TT.prefill(params, toks[:, :S], cfg, max_len=S + 8)
    got, _ = TT.decode_step(params, toks[:, S:], cache, S, cfg)
    want = full[:, -1]
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 2e-3, err


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_layout(arch):
    """Zero caches: the same nesting, shapes and dtypes as the JAX
    package's; the local-attention ring starts with every slot empty."""
    jcfg = jreg.get_smoke_config(arch)
    tcfg = treg.get_smoke_config(arch)
    jc = jax.tree.map(np.asarray, JT.init_cache(jcfg, 2, 12))
    tc = TT.init_cache(tcfg, 2, 12, device="cpu")
    assert len(tc) == len(jc)
    for tg, jg in zip(tc, jc):
        assert len(tg) == len(jg)
        for tcache, jcache in zip(tg, jg):
            assert set(tcache) == set(jcache)
            for name, t in tcache.items():
                assert tuple(t.shape) == jcache[name].shape, name
                assert str(t.dtype).split(".")[-1] == jcache[name].dtype.name
                np.testing.assert_array_equal(t.float().numpy(),
                                              jcache[name].astype(np.float32))


@pytest.mark.parametrize("prompt", [12, 5])
def test_local_attention_ring_decodes_like_forward(rng, prompt):
    """The hybrid config of the JAX package's ``test_models.py`` (window
    8): at prompt lengths that are no multiple of the window, where the
    reference's cache keeps the prompt's last keys in order and its decode
    overwrites a key still in the window (ROADMAP R6), the port's ring
    decodes four chained steps as forward computes them."""
    from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                          RGLRUConfig)
    cfg = ModelConfig(
        name="t", family="hybrid", num_layers=5, d_model=64, d_ff=128,
        vocab_size=256, compute_dtype="float32",
        rglru=RGLRUConfig(d_rnn=64, window=8),
        attention=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=16))
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, 256, (2, prompt + 4)))
    _, cache = TT.prefill(params, toks[:, :prompt], cfg, max_len=prompt + 4)
    pos = cache[0][2]["pos"][0]      # the first local-attention layer
    want_pos = np.full((2, 8), -1)
    for p in range(max(0, prompt - 8), prompt):
        want_pos[:, p % 8] = p
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    for i in range(4):
        got, cache = TT.decode_step(params, toks[:, prompt + i:prompt + i + 1],
                                    cache, prompt + i, cfg)
        full, _ = TT.forward(params, toks[:, :prompt + i + 1], cfg)
        want = full[:, -1]
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err < 2e-3, (i, err)


@pytest.mark.parametrize("arch", list(treg.ARCH_IDS))
def test_param_counts_match_jax(arch):
    """count_params from shapes alone (``init_params`` on the meta device)
    equals the JAX package's count of ``jax.eval_shape`` for every ported
    arch at its full config, and so does active_params."""
    import functools
    jcfg = jreg.get_config(arch)
    shapes = jax.eval_shape(functools.partial(JT.init_params, cfg=jcfg),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tcfg = treg.get_config(arch)
    params = TT.init_params(tcfg, device="meta")
    got = TT.count_params(params)
    assert got == want
    assert TT.active_params(tcfg, got) == JT.active_params(jcfg, want)
    if arch == "llama4-maverick-400b-a17b":   # the reference's band
        assert 370.0 <= got / 1e9 <= 430.0


def test_hybrid_embedding_is_scaled(rng):
    """Gemma's embedding scale: the hybrid family multiplies the embedding
    by sqrt(d_model) in the compute dtype, as the JAX package does."""
    cfg = dataclasses.replace(treg.get_smoke_config("recurrentgemma-9b"),
                              compute_dtype="float32")
    jcfg = dataclasses.replace(jreg.get_smoke_config("recurrentgemma-9b"),
                               compute_dtype="float32")
    embed = rng.normal(size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    got = TT._embed_inputs({"embed": torch.from_numpy(embed)},
                           torch.from_numpy(toks), cfg)
    want = JT._embed_inputs({"embed": jnp.asarray(embed)}, jnp.asarray(toks),
                            jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), 8.0 * embed[toks], rtol=1e-6)


if __name__ == "__main__":
    # the numbers of the module docstring
    print("recurrentgemma-9b bf16, the reference with its GELU rounded "
          "once, moved by (forward, prefill, decode 0-3):",
          _reference_moves_with_one_rounding())
    print("llama4-maverick-400b-a17b bf16, the reference's own error on "
          "tokens routed alike:", _settled_error())
    runs, masks = _runs(ROUTED, "bfloat16"), _masks(ROUTED, "bfloat16")
    print("llama4-maverick-400b-a17b bf16, the port against the "
          "reference where routed alike (forward, decode 0-3):",
          [_rel_where(*runs["forward"], masks["forward"])]
          + [_rel_where(*step, m) for step, m in zip(runs["decode"],
                                                     masks["decode"])])
