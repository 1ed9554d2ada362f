"""granite-4.0-h-small on the port, on the CPU at smoke sizes: the model
against the plain float32 reference ``perfbench/reference/granite_hybrid.py``
on seeded random weights, the dropless expert layer (nothing dropped; the
parts of two held halves add up to the uncut layer), the grouped product's
plain version, the layer pattern, and a run of the benchmark's serving
loop (``perfbench.serving``) on the cell's own files at smoke sizes.  No JAX: the JAX package
has no such model.
"""

import copy
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from perfbench.reference import granite_hybrid as ref  # noqa: E402
from perfbench.reference.common import Precision  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import moe_grouped_gemm as mg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "granite-4.0-h-small"


def _smoke(**kw):
    cfg = registry.get_smoke_config(ARCH)
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _model_dict(cfg) -> dict:
    """A configuration file's ``model`` object of ``cfg``."""
    return dataclasses.asdict(cfg)


def _params(cfg, seed=0):
    """Weights large enough that every part moves the logits: the port's
    init, with the norms' offsets and the conv biases drawn too."""
    params = T.init_params(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def fill(tree):
        if isinstance(tree, list):
            for x in tree:
                fill(x)
            return
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                fill(v)
            elif k in ("scale", "norm_scale", "conv_x_b", "conv_B_b",
                       "conv_C_b"):
                tree[k] = 0.1 * torch.randn(v.shape, generator=gen)
    fill(params)
    return params


def _close(got, want, tol):
    return ((got - want).abs().max() / want.abs().max()).item() < tol


def test_block_groups_follow_the_layer_types():
    cfg = registry.get_config(ARCH)
    groups = T.block_groups(cfg)
    assert groups == [(("mamba_moe",), 5), (("attn_moe",), 1),
                      (("mamba_moe",), 9), (("attn_moe",), 1),
                      (("mamba_moe",), 9), (("attn_moe",), 1),
                      (("mamba_moe",), 9), (("attn_moe",), 1),
                      (("mamba_moe",), 4)]
    assert sum(r for _, r in groups) == 40
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert T.block_groups(registry.get_smoke_config(ARCH)) == [
        (("mamba_moe",), 2), (("attn_moe",), 1), (("mamba_moe",), 1)]
    # the reference's layer walk agrees with the port's groups
    walk = ref.layers(_model_dict(cfg))
    assert [(t, g) for t, g, _ in walk][:7] == [("mamba", 0)] * 5 + [
        ("attention", 1), ("mamba", 2)]
    assert ARCH not in registry.ARCH_IDS
    assert ARCH in registry.PORT_ARCH_IDS


def test_published_size_counts_32_billion_parameters():
    meta = T.init_params(registry.get_config(ARCH), device="meta")
    assert round(T.count_params(meta) / 1e9, 2) == 32.21
    held = dataclasses.replace(
        registry.get_config(ARCH),
        moe=dataclasses.replace(registry.get_config(ARCH).moe,
                                num_experts=36, num_router_experts=72))
    meta = T.init_params(held, device="meta")
    assert round(T.count_params(meta) / 1e9, 2) == 18.62


@pytest.mark.parametrize("first", [0, 4])
def test_forward_matches_the_reference_in_float32(first):
    """Logits of the whole forward against the reference's; float32 on
    both sides, so they differ by the order of sums alone (1e-4 of the
    largest logit covers the SSD scan's chunked sums and the experts'
    scatter-add)."""
    cfg = _smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, num_router_experts=8, first_expert=first))
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (24,),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ref.hidden(params, tokens, _model_dict(cfg), Precision()) \
            @ ref.head_weight(params, _model_dict(cfg))
        got, _ = T.forward(params, tokens[None], cfg)
    assert _close(got[0], want, 1e-4)


def test_prefill_then_decode_matches_the_reference_forward():
    """Prefill of 13 tokens, then 7 decode steps through the hybrid cache
    (conv windows and SSM states beside K/V), each step's logits against
    the reference's full forward at that position: float32, sums in
    another order (1e-4 of the largest logit)."""
    cfg = _smoke()
    params = _params(cfg, seed=5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(4))
    S = 13
    with torch.no_grad():
        last, caches = T.prefill(params, tokens[:, :S], cfg, max_len=20)
        steps = [last]
        for i in range(S, 20 - 1):
            logits, caches = T.decode_step(params, tokens[:, i:i + 1],
                                           caches, i, cfg)
            steps.append(logits)
        head = ref.head_weight(params, _model_dict(cfg))
        for b in range(2):
            want = ref.hidden(params, tokens[b], _model_dict(cfg),
                              Precision()) @ head
            got = torch.stack([s[b] for s in steps])
            assert _close(got, want[S - 1:19], 1e-4), b


def test_the_tensor_position_step_equals_the_int_one():
    """``hidden_step`` at a 0-d device position (as the captured decode
    runs it) is the int position's step, bit for bit."""
    cfg = _smoke()
    params = _params(cfg, seed=6)
    tokens = torch.randint(0, cfg.vocab_size, (3, 9),
                           generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        _, c1 = T.prefill(params, tokens[:, :8], cfg, max_len=12)
        c2 = copy.deepcopy(c1)
        h1, _ = T.hidden_step(params, tokens[:, 8:], c1, 8, cfg)
        h2, _ = T.hidden_step(params, tokens[:, 8:], c2,
                              torch.tensor(8, dtype=torch.int64), cfg)
    assert torch.equal(h1, h2)


def _moe_params(cfg, seed=0):
    return moe_lib.init_moe_params(torch.Generator().manual_seed(seed), 64,
                                   cfg, torch.float32, device="cpu")


def test_held_halves_add_up_to_the_uncut_layer():
    """Expert parallelism's share: the routed parts that the held ranges
    [0, E/2) and [E/2, E) give, with the shared expert counted once, add
    up to the uncut layer's output."""
    E = 8
    whole = moe_lib.MoEConfig(num_experts=E, top_k=3, d_ff_expert=32,
                              d_ff_shared=48, dropless=True)
    p = _moe_params(whole, seed=1)
    x = torch.randn((5, 7, 64), generator=torch.Generator().manual_seed(2))
    parts = []
    for first in (0, E // 2):
        half = dataclasses.replace(whole, num_experts=E // 2,
                                   num_router_experts=E, first_expert=first)
        hp = dict(p, **{n: p[n][first:first + E // 2]
                        for n in ("we_gate", "we_up", "we_down")})
        parts.append(moe_lib.moe_block(hp, x, half))
    shared = moe_lib.mlp_swiglu(x, p["shared"]["w_gate"], p["shared"]["w_up"],
                                p["shared"]["w_down"])
    want = moe_lib.moe_block(p, x, whole)
    got = parts[0] + parts[1] - shared
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    # and against the reference's own held halves
    model = {"moe": {"num_experts": E // 2, "top_k": 3, "first_expert": 0,
                     "d_ff_shared": 48}}
    rp = {n: (v[None] if torch.is_tensor(v) else
              {m: w[None] for m, w in v.items()}) for n, v in p.items()}
    rp.update({n: p[n][None, :E // 2] for n in ("we_gate", "we_up",
                                                 "we_down")})
    h = x.reshape(-1, 64)
    assert torch.allclose(ref.moe(rp, 0, h, model, Precision()),
                          parts[0].reshape(-1, 64), rtol=1e-5, atol=1e-5)


def test_all_tokens_on_one_expert_lose_nothing():
    """A router that sends every token to expert 2 first: 64 tokens on one
    expert, far past any capacity, and each token's output is its own
    top-k experts' sum (none dropped)."""
    cfg = moe_lib.MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                            d_ff_shared=0, dropless=True)
    p = _moe_params(cfg, seed=3)
    x = torch.randn((64, 64), generator=torch.Generator().manual_seed(4))
    x[:, 0] = x[:, 0].abs() + 1.0
    p["router"] = p["router"].clone()
    p["router"][0, 2] = 100.0
    got = moe_lib.moe_block(p, x, cfg)
    gates, idx = moe_lib.router_topk(x @ p["router"], 2)
    assert (idx[:, 0] == 2).all()
    want = torch.zeros_like(x)
    for t in range(64):
        for j in range(2):
            e = idx[t, j]
            h = (torch.nn.functional.silu(x[t] @ p["we_gate"][e])
                 * (x[t] @ p["we_up"][e]))
            want[t] += gates[t, j] * (h @ p["we_down"][e])
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got.abs().sum(-1) > 0).all()


def test_static_and_exact_sizing_agree():
    """The decode's buffers for every pair (nothing read on the host) and
    the prefill's for the held pairs only give the same layer."""
    cfg = moe_lib.MoEConfig(num_experts=3, top_k=2, d_ff_expert=32,
                            d_ff_shared=16, dropless=True,
                            num_router_experts=8, first_expert=2)
    p = _moe_params(cfg, seed=7)
    x = torch.randn((40, 64), generator=torch.Generator().manual_seed(8))
    outs = []
    for static in (True, False):
        tok, gate, offsets, counts = moe_lib.route_held(x, p["router"], cfg,
                                                        static)
        assert int(offsets[-1]) == int(counts.sum())
        assert tok.shape[0] == (80 if static else int(counts.sum()))
        outs.append((tok, gate, offsets))
    (t1, g1, o1), (t2, g2, o2) = outs
    n = int(o2[-1])
    assert torch.equal(o1, o2) and torch.equal(t1[:n], t2)
    assert torch.equal(g1[:n], g2)
    # the grouped products over both: the static rows past the held pairs
    # (those of no held expert) come out zero, the others alike
    ys = []
    for tok, off in ((t1, o1), (t2, o2)):
        h = ops.moe_grouped_gemm(x.index_select(0, tok), p["we_gate"], off,
                                 w_up=p["we_up"])
        ys.append(ops.moe_grouped_gemm(h, p["we_down"], off))
    assert n < 80 and (ys[0][n:] == 0).all()
    assert torch.equal(ys[0][:n], ys[1])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("counts", [[3, 0, 1, 5], [0, 0, 9, 0], [1, 1, 1, 1],
                                    [0, 0, 0, 0]])
def test_grouped_plain_matches_matmul_per_expert(gated, counts):
    """The plain grouped product against ``torch.matmul`` expert by expert,
    with empty and one-row experts, and rows past the last expert's zero."""
    gen = torch.Generator().manual_seed(sum(counts))
    E, K, N, M = 4, 64, 48, sum(counts) + 3
    a = torch.randn((M, K), generator=gen, dtype=torch.float64)
    w = torch.randn((E, K, N), generator=gen, dtype=torch.float64)
    u = torch.randn((E, K, N), generator=gen, dtype=torch.float64)
    offsets = torch.tensor([0] + list(torch.tensor(counts).cumsum(0)),
                           dtype=torch.int32)
    got = ops.moe_grouped_gemm(a, w, offsets, w_up=u if gated else None)
    want = torch.zeros((M, N), dtype=torch.float64)
    for e in range(E):
        lo, hi = int(offsets[e]), int(offsets[e + 1])
        y = torch.matmul(a[lo:hi], w[e])
        if gated:
            y = torch.nn.functional.silu(y) * torch.matmul(a[lo:hi], u[e])
        want[lo:hi] = y
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got[sum(counts):] == 0).all()


def test_grouped_bounds_count_the_touched_experts():
    assert mg.flops(10, 64, 32, True) == 2 * 2 * 10 * 64 * 32
    assert mg.min_bytes(10, 3, 64, 32, False) == 2 * (3 * 64 * 32
                                                      + 10 * (64 + 32))
    assert mg.tile_rows(320, 36) == 16 and mg.tile_rows(81920, 36) == 128


def test_smoke_config_keeps_every_mechanism():
    cfg = registry.get_smoke_config(ARCH)
    assert set(cfg.layer_types) == {"mamba", "attention"}
    assert cfg.moe.dropless and cfg.moe.d_ff_shared and cfg.moe.top_k == 3
    assert not cfg.attention.rope and cfg.attention.softmax_scale
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.norm_eps) == (12.0, 0.22, 16.0, 1e-5)
    full = registry.get_config(ARCH)
    assert full.ssm.num_heads(full.d_model) == 128
    assert full.moe.router_width == 72 and full.attention.group_size == 4


def _serve_cell(seed):
    """The ``granite-4.0-h-small.chat`` cell's files at smoke sizes on the
    CPU (every width cut, the held share kept: half the router's
    experts)."""
    from perfbench import manifest as mf
    from perfbench.run import context
    files = mf.cell(mf.load(), ARCH + ".chat")
    c = copy.deepcopy({k: v for k, v in files.items() if k != "reference"})
    c["reference"] = files["reference"]
    model = c["config"]["model"]
    smoke = registry.get_smoke_config(ARCH)
    model.update(num_layers=4, d_model=64, vocab_size=512,
                 layer_types=list(smoke.layer_types),
                 compute_dtype="float32")
    model["attention"].update(num_heads=4, num_kv_heads=2, head_dim=16,
                              softmax_scale=1.0 / 16)
    model["moe"].update(num_experts=4, num_router_experts=8, top_k=3,
                        d_ff_expert=32, d_ff_shared=48)
    model["ssm"].update(d_state=16, head_dim=16, chunk_size=8)
    c["traffic"].update(batch=3, prompt=16, gen=5, trace_decode_steps=2)
    return context(c, seed, 0.5, False, torch.device("cpu"),
                   time.perf_counter()), c


def test_serving_runs_the_cell_and_is_correct():
    """The benchmark's serving loop on the cell's own configuration file at
    smoke sizes: the weights from its init rules, served through
    ``ProgressiveServer``, and the sample's tokens within a hundredth of
    the reference's best logits (float32 on both sides)."""
    from perfbench import serving
    ctx, _ = _serve_cell(20240601)
    rec = serving.run(ctx)
    assert rec["requests"] >= 3 and rec["graph_captures"] == 0
    assert serving.check(rec, ctx)["token_gap"] < 1e-2
