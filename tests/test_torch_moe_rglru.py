"""Port parity: the RG-LRU block and the MoE block, module by module.

Each case hands the same NumPy inputs and the JAX package's parameters
(carried over with ``models.convert``) to ``repro.models.rglru`` /
``repro.models.moe`` and to the port, in fp32, and compares at 1e-4
absolute and relative, the tolerance of the model parity tests: the same
fp32 arithmetic in another order (the port's doubling scan against
``jax.lax.associative_scan``'s tree).  The MoE cases compare the router's
chosen experts before the outputs, so a failure says whether routing or
arithmetic differs.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import RGLRUConfig as JRGLRU  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs.base import MoEConfig, RGLRUConfig  # noqa: E402
from repro_torch.models import convert, moe, rglru  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = 1e-4
D = 64


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _rglru_params(seed=1):
    cfg, jcfg = RGLRUConfig(d_rnn=48), JRGLRU(d_rnn=48)
    jp = jrglru.init_rglru_params(jax.random.PRNGKey(seed), D, jcfg,
                                  jnp.float32)
    return cfg, jcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_linear_scan_equals_the_recurrence(rng, S):
    """Recursive doubling against the loop it replaces, at lengths that
    are and are not powers of two."""
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, S, 5)))
    b = torch.from_numpy(rng.normal(size=(2, S, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b),
                               torch.stack(want, 1), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("init", [False, True])
def test_rglru_block_matches_jax(rng, init):
    cfg, jcfg, jp, tp = _rglru_params()
    x = rng.normal(size=(2, 21, D)).astype(np.float32)
    h0 = rng.normal(size=(2, 48)).astype(np.float32) if init else None
    jy, jc = jrglru.rglru_block(jp, jnp.asarray(x), jcfg,
                                None if h0 is None else jnp.asarray(h0))
    ty, tc = rglru.rglru_block(tp, torch.from_numpy(x), cfg,
                               None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])


def test_rglru_decode_step_matches_jax_and_the_block(rng):
    """Three decode steps after a prefill, against the JAX package's steps
    on the same caches, and against the block over the longer sequence."""
    cfg, jcfg, jp, tp = _rglru_params(seed=2)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    _, jc = jrglru.rglru_block(jp, jnp.asarray(x[:, :9]), jcfg)
    _, tc = rglru.rglru_block(tp, torch.from_numpy(x[:, :9]), cfg)
    steps = []
    for t in range(9, 12):
        jy, jc = jrglru.rglru_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                          jcfg)
        ty, tc = rglru.rglru_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                         tc, cfg)
        _close(ty, jy)
        _close(tc["h"], jc["h"])
        steps.append(ty)
    full, _ = rglru.rglru_block(tp, torch.from_numpy(x), cfg)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 9:], atol=TOL,
                               rtol=TOL)


def test_rglru_prompt_shorter_than_the_conv_window(rng):
    """A one-token prompt leaves a conv window of zeros before it, so the
    steps after it agree with the block over the whole sequence."""
    cfg, _, _, tp = _rglru_params(seed=3)
    x = torch.from_numpy(rng.normal(size=(2, 4, D)).astype(np.float32))
    _, cache = rglru.rglru_block(tp, x[:, :1], cfg)
    assert tuple(cache["conv"].shape) == (2, 3, 48)
    steps = []
    for t in range(1, 4):
        y, cache = rglru.rglru_decode_step(tp, x[:, t:t + 1], cache, cfg)
        steps.append(y)
    full, _ = rglru.rglru_block(tp, x, cfg)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 1:], atol=TOL,
                               rtol=TOL)


def _moe(E=8, k=2, cf=1.0, shared=32, seed=4):
    kw = dict(num_experts=E, top_k=k, d_ff_expert=40, d_ff_shared=shared,
              capacity_factor=cf)
    jcfg, cfg = JMoE(**kw), MoEConfig(**kw)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, jcfg,
                              jnp.float32)
    return cfg, jcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.mark.parametrize("T,group,cf,shared", [
    (30, 12, 1.0, 32),     # T no multiple of the group: Tg = gcd = 6
    (32, 16, 0.5, 0),      # capacity 2 of 4 choices a group: drops
    (24, None, 4.0, 32),   # one group, lossless
])
def test_moe_block_matches_jax(rng, T, group, cf, shared):
    cfg, jcfg, jp, tp = _moe(cf=cf, shared=shared)
    x = rng.normal(size=(T, D)).astype(np.float32)
    logits = x @ np.asarray(jp["router"])
    _, jidx = jmoe.router_topk(jnp.asarray(logits), cfg.top_k)
    _, tidx = moe.router_topk(torch.from_numpy(logits), cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    want = jmoe.moe_block(jp, jnp.asarray(x.reshape(2, T // 2, D)), jcfg,
                          group_size=group)
    got = moe.moe_block(tp, torch.from_numpy(x.reshape(2, T // 2, D)), cfg,
                        group_size=group)
    assert got.shape == (2, T // 2, D)
    _close(got, want)


def test_moe_drops_pass_through_the_residual(rng):
    """At a capacity below the load some (token, choice) pairs are
    dropped: the block's output for them is the shared expert's alone."""
    cfg, _, _, tp = _moe(k=1, cf=0.25, shared=0)
    x = torch.from_numpy(rng.normal(size=(32, D)).astype(np.float32))
    y = moe.moe_block(tp, x, cfg)
    assert (y.abs().sum(-1) == 0).any() and (y.abs().sum(-1) > 0).any()


def test_router_topk_breaks_ties_towards_the_lower_index():
    """Exact ties at the k-th place go to the lower expert index, as in
    ``jax.lax.top_k``."""
    logits = np.array([[1.0, 2.0, 2.0, 0.5, 2.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [3.0, 1.0, 3.0, 1.0, 3.0, 1.0]], np.float32)
    for k in (1, 2, 3):
        jg, jidx = jmoe.router_topk(jnp.asarray(logits), k)
        tg, tidx = moe.router_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _close(tg, jg)
    assert tidx[1].tolist() == [0, 1, 2]


def test_mlp_swiglu_matches_jax(rng):
    x, wg, wu = (rng.normal(size=s).astype(np.float32)
                 for s in ((3, D), (D, 24), (D, 24)))
    wd = rng.normal(size=(24, D)).astype(np.float32)
    _close(tlayers.mlp_swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           jlayers.mlp_swiglu(*map(jnp.asarray, (x, wg, wu, wd))))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b", "llama3-8b"])
def test_lossless_capacity_holds_every_token(arch):
    """``lossless_capacity`` changes only the capacity factor, to one at
    which an expert's buffer holds a whole group; a config without
    experts comes back as it is."""
    import dataclasses
    import math

    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    got = moe.lossless_capacity(cfg)
    if cfg.moe is None:
        assert got is cfg
        return
    assert dataclasses.replace(got, moe=cfg.moe) == cfg
    m = got.moe
    assert dataclasses.replace(m, capacity_factor=cfg.moe.capacity_factor) \
        == cfg.moe
    for Tg in (2, 7, 4096):
        assert math.ceil(Tg / m.num_experts * m.top_k
                         * m.capacity_factor) >= Tg


@pytest.mark.parametrize("helper", ["init_rglru_params", "init_rglru_cache",
                                    "init_moe_params"])
def test_init_helpers_default_to_cuda(monkeypatch, helper):
    """Like every constructor of the port, these make their tensors on the
    card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    call = {
        "init_rglru_params": lambda **kw: rglru.init_rglru_params(
            gen, 16, RGLRUConfig(d_rnn=8), torch.float32, **kw),
        "init_rglru_cache": lambda **kw: rglru.init_rglru_cache(
            2, 16, RGLRUConfig(d_rnn=8), torch.float32, **kw),
        "init_moe_params": lambda **kw: moe.init_moe_params(
            gen, 16, MoEConfig(num_experts=4, top_k=1, d_ff_expert=8,
                               d_ff_shared=8), torch.float32, **kw),
    }[helper]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    flat = [t for v in out.values()
            for t in (v.values() if isinstance(v, dict) else [v])]
    assert all(t.device.type == "cpu" for t in flat)
