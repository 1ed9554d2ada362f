"""Port parity: the models (configs, layers, Mamba2 SSM, transformer).

The JAX package's parameters for the llama3-8b and mamba2-370m smoke
configs are carried into the port with ``models.convert``; both packages
then run the same tokens.  Forward logits, prefill caches and last
logits, and four chained decode steps must agree:

* at ``compute_dtype="float32"`` within 1e-4 (absolute and relative): the
  two packages run the same fp32 arithmetic in another summation order,
  and the port's prefill goes through the kernels' plain versions, which
  the JAX models compute with jnp (a few ulps of fp32 after two layers);
* at the default bf16 within 2e-2 of the largest value: bf16 keeps 8
  bits (unit roundoff 3.9e-3), and the two frameworks round activations
  at different places (XLA fuses, PyTorch rounds every op's output), so a
  few roundoffs of the largest logit.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["llama3-8b", "mamba2-370m"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, DECODE = 2, 16, 4


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    tol = TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err <= tol, f"{what}: {err} of the largest value"


@contextlib.contextmanager
def _recording_routers():
    """While open, every MoE router call of both packages is recorded:
    yields ``(port, ref)``, two lists that gain each call's router logits
    (fp32 NumPy) and chosen experts, in call order.  The JAX package's
    calls are recorded by an ordered ``jax.debug.callback``, so inside jit
    and scan too, but only in functions traced while the block is open."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    port, ref = [], []
    jtopk, ttopk = jmoe.router_topk, tmoe.router_topk

    def jrecord(logits, k):
        gates, idx = jtopk(logits, k)
        jax.debug.callback(lambda lg, i: ref.append(
            (np.asarray(lg, np.float32), np.asarray(i))), logits, idx,
            ordered=True)
        return gates, idx

    def trecord(logits, k):
        gates, idx = ttopk(logits, k)
        port.append((logits.float().numpy(), idx.numpy()))
        return gates, idx

    jmoe.router_topk, tmoe.router_topk = jrecord, trecord
    try:
        yield port, ref
    finally:
        jmoe.router_topk, tmoe.router_topk = jtopk, ttopk


@functools.lru_cache(maxsize=None)
def _runs(arch, dtype):
    """Both packages on the same weights and tokens (cached per case),
    with the router calls of each phase (:func:`_recording_routers`;
    empty lists for a config without experts).  The JAX functions are
    traced here, as closures of their own, so that the recording sees
    them."""
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(treg.get_smoke_config(arch),
                               compute_dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + DECODE)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    out = {"cfg": tcfg, "routes": {}}
    jforward = jax.jit(lambda p, t: JT.forward(p, t, jcfg))
    jprefill = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, S + DECODE))
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg))
    with _recording_routers() as (port, ref):
        def routes():
            jax.effects_barrier()
            calls = (list(port), list(ref))
            port.clear()
            ref.clear()
            return calls
        jl, _ = jforward(jp, jnp.asarray(toks))
        tl, _ = TT.forward(tp, tt, tcfg)
        out["forward"] = (tl, jl)
        out["routes"]["forward"] = routes()
        jlast, jc = jprefill(jp, jnp.asarray(toks[:, :S]))
        tlast, tc = TT.prefill(tp, tt[:, :S], tcfg, max_len=S + DECODE)
        out["prefill"] = (tlast, jlast)
        out["routes"]["prefill"] = routes()
        # every group's caches, unit by unit (decode below updates the
        # port's in place, so they are copied here)
        out["caches"] = ([{n: t.clone() for n, t in c.items()}
                          for group in tc for c in group],
                         [c for group in jax.tree.map(np.asarray, jc)
                          for c in group])
        steps, out["routes"]["decode"] = [], []
        for i in range(DECODE):
            jg, jc = jdecode(jp, jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                             jnp.int32(S + i))
            tg, tc = TT.decode_step(tp, tt[:, S + i:S + i + 1], tc, S + i,
                                    tcfg)
            steps.append((tg, jg))
            out["routes"]["decode"].append(routes())
    out["decode"] = steps
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, dtype):
    got, want = _runs(arch, dtype)["forward"]
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _close(got, want, dtype, "forward logits")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits_and_caches_match_jax(arch, dtype):
    runs = _runs(arch, dtype)
    got, want = runs["prefill"]
    _close(got, want, dtype, "prefill last logits")
    tcaches, jcaches = runs["caches"]
    for tcache, jcache in zip(tcaches, jcaches):
        assert set(tcache) == set(jcache)
        for name in tcache:
            assert tuple(tcache[name].shape) == jcache[name].shape, name
            _close(tcache[name], jcache[name], dtype, f"cache {name}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_decode_steps_match_jax(arch, dtype):
    for i, (got, want) in enumerate(_runs(arch, dtype)["decode"]):
        _close(got, want, dtype, f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(rng, arch):
    """Within the port: the invariant that catches cache/RoPE/mask bugs
    (the JAX package's ``test_decode_matches_forward``)."""
    cfg = dataclasses.replace(treg.get_smoke_config(arch),
                              compute_dtype="float32")
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + 1)))
    full, _ = TT.forward(params, toks, cfg)
    _, cache = TT.prefill(params, toks[:, :S], cfg, max_len=S + 8)
    got, _ = TT.decode_step(params, toks[:, S:], cache, S, cfg)
    want = full[:, -1]
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 2e-3, err


def test_ssm_prefill_pads_to_the_chunk(rng):
    """A prompt that is no multiple of the chunk: the padded steps carry
    dt = 0, so the final state is the state at position S (JAX agrees)."""
    from repro.configs.base import SSMConfig as JSSM
    from repro.models import ssm as jssm
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import ssm
    cfg = SSMConfig(d_state=16, head_dim=16, chunk_size=8)
    jcfg = JSSM(d_state=16, head_dim=16, chunk_size=8)
    jp = jssm.init_ssm_params(jax.random.PRNGKey(1), 64, jcfg, jnp.float32)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(2, 13, 64)).astype(np.float32)
    jy, jc = jax.jit(jssm.ssm_block, static_argnums=(2, 3))(
        jp, jnp.asarray(x), 64, jcfg)
    ty, tc = ssm.ssm_block(tp, torch.from_numpy(x), 64, cfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc["state"].numpy(), _np(jc["state"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-4.0-h-small"])
def test_ssm_decode_step_on_the_cpu_runs_the_plain_step(rng, monkeypatch,
                                                        arch, dtype):
    """On CPU tensors ``kernels.ops.ssm_step`` runs ``ssm_step_plain``
    and never the kernel, and ``ssm_decode_step`` is that plain step
    between ``_streams`` and ``out_proj`` bit for bit, over three chained
    steps of the smoke config's Mamba2 layer: new cache tensors each
    step, the given ones untouched."""
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.models import ssm
    cfg = treg.get_smoke_config(arch)
    dt = getattr(torch, dtype)
    plain, calls = sst.ssm_step_plain, []

    def counted(*args):
        calls.append(args)
        return plain(*args)

    def kernel(*args):
        raise AssertionError("the kernel ran on CPU tensors")

    monkeypatch.setattr(sst, "ssm_step_plain", counted)
    monkeypatch.setattr(sst, "ssm_step_kernel_call", kernel)
    gen = torch.Generator().manual_seed(0)
    params = ssm.init_ssm_params(gen, cfg.d_model, cfg.ssm, torch.float32,
                                 device="cpu")
    cache = {n: torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype)
             for n, t in ssm.init_ssm_cache(2, cfg.d_model, cfg.ssm, dt,
                                            device="cpu").items()}
    eps = TT._ssm_eps(cfg)
    for step in range(3):
        x = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model))).to(dt)
        given = {n: t.clone() for n, t in cache.items()}
        got, new = ssm.ssm_decode_step(params, x, cache, cfg.d_model,
                                       cfg.ssm, eps=eps)
        want, want_c = plain(params, ssm._streams(params, x), given, eps)
        assert len(calls) == step + 1
        assert torch.equal(got, want @ params["out_proj"].to(dt))
        assert got.dtype == dt
        for n, t in cache.items():
            assert new[n] is not t and torch.equal(t, given[n]), n
            assert torch.equal(new[n], want_c[n]), n
        cache = new


@pytest.mark.parametrize("init", [False, True])
def test_plain_ssd_scan_matches_jax(rng, init):
    """``models.ssm.ssd_scan``, the plain scan with the reference's
    signature, against the JAX model's ``ssd_scan`` (fp32, 1e-4 as the
    kernel cases); with and without an initial state."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    B, S, H, P, N, chunk = 2, 48, 4, 8, 16, 16
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if init else None
    args = (x, dt, A, Bm, Cm)
    want_y, want_s = jssm.ssd_scan(
        *map(jnp.asarray, args), chunk,
        None if s0 is None else jnp.asarray(s0))
    got_y, got_s = ssm.ssd_scan(
        *map(torch.from_numpy, args), chunk,
        None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), atol=1e-4,
                               rtol=1e-4)


def test_layers_match_jax(rng):
    """rope, the norms and decode attention on the same inputs."""
    from repro.configs.base import AttentionConfig as JAttn
    from repro.models import layers as JL
    from repro_torch.configs.base import AttentionConfig
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
        .numpy(), _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        atol=1e-5, rtol=1e-5)
    h = rng.normal(size=(3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
        _np(JL.rms_norm(jnp.asarray(h), jnp.asarray(w))), atol=1e-5,
        rtol=1e-5)
    np.testing.assert_allclose(
        TL.layer_norm(torch.from_numpy(h), torch.from_numpy(w),
                      torch.from_numpy(b)).numpy(),
        _np(JL.layer_norm(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))),
        atol=1e-5, rtol=1e-5)
    acfg = AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                           window=3)
    jacfg = JAttn(num_heads=4, num_kv_heads=2, head_dim=16, window=3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    p = np.array([6, 6], np.int32)
    got = TL.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                              torch.from_numpy(p).long(), acfg,
                              torch.from_numpy(p + 1).long())
    want = JL.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                               jnp.asarray(p), jacfg, jnp.asarray(p + 1))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_plain_attention_matches_jax_with_softcap(rng):
    """``layers.attention`` stays the plain general function (softcap,
    query chunks) that the kernel path does not cover."""
    from repro.configs.base import AttentionConfig as JAttn
    from repro.models import layers as JL
    from repro_torch.configs.base import AttentionConfig
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16,
              attn_logit_softcap=30.0)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(8), (2, 1)).astype(np.int32)
    got = TL.attention(*map(torch.from_numpy, (q, k, k, pos, pos)),
                       AttentionConfig(**kw), q_chunk=4)
    want = JL.attention(*map(jnp.asarray, (q, k, k, pos, pos)), JAttn(**kw),
                        q_chunk=4)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def _matches_jax(jd: dict, td: dict, cls) -> None:
    """Every field of the JAX package's config (``jd``, nested configs
    included) equal in the port's (``td``); every field of the port alone
    (its ``cls``) at its default."""
    from repro_torch.configs import base as tbase
    nested = {"attention": tbase.AttentionConfig, "moe": tbase.MoEConfig,
              "ssm": tbase.SSMConfig, "rglru": tbase.RGLRUConfig}
    assert set(jd) <= set(td), sorted(set(jd) - set(td))
    for f in dataclasses.fields(cls):
        if f.name not in jd:
            assert td[f.name] == f.default, f.name
        elif f.name in nested and jd[f.name] is not None:
            _matches_jax(jd[f.name], td[f.name], nested[f.name])
        else:
            assert td[f.name] == jd[f.name], f.name


def test_block_groups_and_configs_match_jax():
    from repro_torch.configs import base as tbase
    for arch in treg.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            jcfg = getattr(jreg, get)(arch)
            tcfg = getattr(treg, get)(arch)
            assert JT.block_groups(jcfg) == TT.block_groups(tcfg)
            jd = dataclasses.asdict(jcfg)
            td = dataclasses.asdict(tcfg)
            _matches_jax(jd, td, tbase.ModelConfig)
    assert treg.get_config("llama3-8b").cdtype() == torch.bfloat16
    assert treg.get_config("llama3-8b").pdtype() == torch.float32
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    with pytest.raises(KeyError):
        treg.get_config("whisper-base")


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_unported_kinds_raise(arch):
    """The layer kinds and extras that raised before they were ported (the
    ``cross`` kind, the audio and vlm inputs) now build: the published
    config's parameters, on the ``meta`` device, count what the JAX
    package's count, and nothing raises ``NotImplementedError``."""
    jcfg = jreg.get_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    params = TT.init_params(treg.get_config(arch), device="meta")
    assert TT.count_params(params) == want


def test_softcap_config_raises():
    from repro_torch.configs.base import AttentionConfig
    cfg = dataclasses.replace(
        treg.get_smoke_config("llama3-8b"),
        attention=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=16,
                                  attn_logit_softcap=50.0))
    with pytest.raises(NotImplementedError, match="softcap"):
        TT.init_params(cfg, device="cpu")


def test_init_params_defaults_to_cuda(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without a GPU, the default raises and ``device="cpu"`` works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_smoke_config("mamba2-370m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 1, 8)
    params = TT.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


def _helper_calls():
    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import ssm
    cfg = SSMConfig(d_state=16, head_dim=8, chunk_size=8)
    gen = torch.Generator()
    return {
        "init_linear": lambda **kw: TL.init_linear(gen, 4, 8, torch.float32,
                                                   **kw),
        "init_norm": lambda **kw: TL.init_norm(8, torch.float32, **kw),
        "init_ssm_params": lambda **kw: ssm.init_ssm_params(
            gen, 32, cfg, torch.float32, **kw),
        "init_ssm_cache": lambda **kw: ssm.init_ssm_cache(
            2, 32, cfg, torch.float32, **kw),
    }


@pytest.mark.parametrize("helper", ["init_linear", "init_norm",
                                    "init_ssm_params", "init_ssm_cache"])
def test_init_helpers_default_to_cuda(monkeypatch, helper):
    """The exported init helpers, like ``init_params``, make their tensors
    on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _helper_calls()[helper]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    tensors = out.values() if isinstance(out, dict) else [out]
    assert all(t.device.type == "cpu" for t in tensors)


def test_to_torch_copies_tensor_trees():
    """``convert.to_torch`` takes tensors as well as arrays: the same
    nesting, the same values and dtype, each in memory of its own."""
    tree = {"a": [torch.arange(4, dtype=torch.bfloat16)],
            "b": (np.ones(3, np.float32), torch.zeros(2, dtype=torch.int32))}
    got = convert.to_torch(tree, "cpu")
    assert isinstance(got["a"], list) and isinstance(got["b"], tuple)
    for g, w in ((got["a"][0], tree["a"][0]), (got["b"][1], tree["b"][1])):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert g.data_ptr() != w.data_ptr()
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax_layout(arch):
    """Zero caches: the same nesting, shapes and dtypes as the JAX
    package's (decode from an empty cache needs no prefill)."""
    jcfg = jreg.get_smoke_config(arch)
    tcfg = treg.get_smoke_config(arch)
    jc = jax.tree.map(np.asarray, JT.init_cache(jcfg, 2, 12))
    tc = TT.init_cache(tcfg, 2, 12, device="cpu")
    assert len(tc) == len(jc)
    for tg, jg in zip(tc, jc):
        for tcache, jcache in zip(tg, jg):
            assert set(tcache) == set(jcache)
            for name, t in tcache.items():
                assert tuple(t.shape) == jcache[name].shape, name
                assert str(t.dtype).split(".")[-1] == jcache[name].dtype.name
                assert not t.any()
