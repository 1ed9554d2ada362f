"""The grouped-product kernel and the dropless expert layer on the card:
the kernel against its plain version at granite-4.0-h-small's decode and
prefill shapes and at ragged, empty and one-expert counts, and the
smoke-size hybrid's captured decode step against its eager step while its
routing changes.  These tests need an NVIDIA Hopper GPU and ``nvcc``;
elsewhere they skip.  They import nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import moe_grouped_gemm as mg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    """The card to run on; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) device")
    return torch.device("cuda", 0)


def _counts(kind: str, E: int, M: int, gen) -> list:
    if kind == "ragged":
        base = [0, 1, 17, 0, 129, 2, 0, 64, 16, 15, 33, 0]
        return (base * (E // len(base) + 1))[:E]
    if kind == "empty":
        return [0] * E
    if kind == "one":
        return [0] * (E // 2) + [M] + [0] * (E - E // 2 - 1)
    # decode / prefill: the pairs of uniform routing, about half held
    held = torch.multinomial(torch.ones(E), M // 2, replacement=True,
                             generator=gen)
    return torch.bincount(held, minlength=E).tolist()


# (case, rows M, experts, K, N): granite's decode step of 32 tokens (320
# pairs, the held ones first) and a prefill part (16384 tokens: about
# 81920 held pairs, sized exactly), both products each
CASES = [("decode", 320, 36, 4096, 768), ("decode", 320, 36, 768, 4096),
         ("prefill", 81920, 36, 4096, 768), ("prefill", 81920, 36, 768, 4096),
         ("ragged", 1000, 36, 4096, 768), ("ragged", 4000, 36, 768, 4096),
         ("empty", 320, 36, 4096, 768), ("one", 320, 36, 4096, 768),
         ("one", 5000, 36, 768, 4096)]


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("case,M,E,K,N", CASES)
def test_grouped_kernel_matches_plain(hopper, case, M, E, K, N, gated):
    """bf16 products against the plain version on the same inputs: within
    two bf16 steps of the largest value (the fp32 sums' order differs,
    then both round to bf16), and the rows of no expert exactly zero."""
    gen = torch.Generator().manual_seed(M + K + E)
    counts = _counts(case, E, M, gen)
    if case == "prefill":       # sized exactly: every row is held
        M = sum(counts)
    offsets = torch.tensor([0] + torch.tensor(counts).cumsum(0).tolist(),
                           dtype=torch.int32, device=hopper)
    dgen = torch.Generator(device=hopper).manual_seed(M)
    a = torch.randn((M, K), generator=dgen, device=hopper).to(torch.bfloat16)
    w, u = ((torch.randn((E, K, N), generator=dgen, device=hopper)
             / math.sqrt(K)).to(torch.bfloat16) for _ in range(2))
    u = u if gated else None
    before = mg.launches
    got = ops.moe_grouped_gemm(a, w, offsets, w_up=u)
    torch.cuda.synchronize()
    assert mg.launches == before + 1
    want = mg.moe_grouped_gemm_plain(a, w, offsets, u)
    held = sum(counts)
    assert torch.isfinite(got).all()
    assert (got[held:] == 0).all()
    scale = max(want.float().abs().max().item(), 1e-30)
    assert (got.float() - want.float()).abs().max().item() \
        <= 2 * 2 ** -8 * scale


def test_decode_graph_replays_equal_the_eager_step(hopper):
    """The smoke hybrid (widths that the kernel takes) in bf16: one
    captured greedy step replayed token after token, each against the
    eager step on the same tokens and caches.  The tokens differ at every
    step, so the routing does.  Logits within 2 % of the largest (the
    experts' fp32 scatter-add is summed in another order each call, then
    rounded to bf16 through the later layers)."""
    from repro_torch.launch.serve import ProgressiveServer, _copy_into
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = registry.get_smoke_config("granite-4.0-h-small")
    cfg = dataclasses.replace(
        cfg, d_model=128, vocab_size=512, compute_dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, num_experts=4,
                                num_router_experts=8, d_ff_expert=64,
                                d_ff_shared=128))
    params = T.init_params(cfg, seed=1, device=hopper)
    B, S = 8, 24
    gen = torch.Generator(device=hopper).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=hopper)
    feed = torch.randint(0, cfg.vocab_size, (B, 6), generator=gen,
                         device=hopper)
    with ProgressiveServer(cfg, params, device=hopper) as server:
        _, caches = server.prefill(prompt, S + 8)
        eager = tree_map(torch.clone, caches)
        graph = server._graph(caches, B, server.m)
        _copy_into(graph.caches, caches)
        graph.start(feed[:, :1], S)
        before = mg.launches
        for i in range(6):
            graph.tok.copy_(feed[:, i:i + 1])
            graph.replay()
            with torch.no_grad():
                want = server._step(feed[:, i:i + 1].clone(),
                                    torch.tensor(S + i, device=hopper),
                                    eager, server.m)
            got = graph.out
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 2e-2 * scale, i
        # the eager steps' only: two products in each of the 4 layers
        assert mg.launches == before + 6 * 4 * 2
    assert not torch.equal(feed[:, 0], feed[:, 1])
