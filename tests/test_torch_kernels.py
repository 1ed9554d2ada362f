"""Port parity: the three kernels and their ``ops`` wrappers.

On the CPU the port's wrappers run each kernel's plain PyTorch version.
The layered matmul's partials must be bit-equal to the JAX package's
Pallas kernel run in interpret mode; flash attention and the SSD scan
must agree with theirs within the reference's own tolerances, on the same
cases as ``tests/test_kernels.py``.  The card-side comparison of the CUDA
kernels with their plain versions is ``tests/test_torch_cuda.py``; the
cases here that need a card hold the layered CUDA kernel against the JAX
package.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import layering as jl  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import layering  # noqa: E402
from repro_torch.kernels import layered_matmul as lm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _alias_pallas_tpu_params():
    """Run the JAX package's Pallas kernel in interpret mode on this JAX.

    ``repro/kernels/layered_matmul.py`` names ``pltpu.TPUCompilerParams``,
    which newer JAX releases renamed ``CompilerParams``.  The alias is set
    once, when this file is collected, and holds for the whole process:
    ``layered_matmul_kernel_call`` is jitted, so an alias that lasted one
    test left traced cases behind it and made ``tests/test_kernels.py``
    pass or fail by which file ran first in a worker.  Every pytest
    process, an xdist worker included, collects this file before it runs
    a test.  The JAX package is not edited.
    """
    from jax.experimental.pallas import tpu as pltpu
    if not hasattr(pltpu, "TPUCompilerParams"):
        pltpu.TPUCompilerParams = pltpu.CompilerParams


_alias_pallas_tpu_params()


@pytest.fixture
def hopper():
    """The card to run on; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) device")
    return torch.device("cuda", 0)


REFERENCE_CASES = [
    (2, 7, 64, 16, 24),
    (2, 7, 1024, 128, 128),   # multi-block K accumulation
    (3, 5, 128, 128, 128),
    (4, 4, 32, 8, 8),
    (1, 7, 16, 8, 8),         # degenerate single layer
]


def _operands(rng, m, d, K, M, N):
    hi = 1 << (m * d - 1)
    return (rng.integers(-hi, hi, size=(K, M)).astype(np.int32),
            rng.integers(-hi, hi, size=(K, N)).astype(np.int32))


@pytest.mark.parametrize("m,d,K,M,N", REFERENCE_CASES)
def test_partials_bit_equal_to_jax_interpret(rng, m, d, K, M, N):
    A, B = _operands(rng, m, d, K, M, N)
    want = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    got = ops.layered_matmul_partials(torch.from_numpy(A),
                                      torch.from_numpy(B), m=m, d=d)
    assert got.dtype == torch.int32 and got.shape == (2 * m - 1, M, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,d,K,R", [(2, 7, 37, 5), (3, 5, 64, 9),
                                     (1, 7, 16, 3)])
def test_kmajor_planes_are_decompose_of_transpose_padded(rng, m, d, K, R):
    """The ops wrapper's K-major planes are the reference's planes of
    ``x.T`` cast to int8, with K padded by zeros to a multiple of 16."""
    hi = 1 << 20     # beyond m*d bits as well: the int8 store wraps
    x = rng.integers(-hi, hi, size=(K, R)).astype(np.int32)
    got = ops._planes_kmajor(torch.from_numpy(x), m, d)
    kp = -(-K // lm.K_ALIGN) * lm.K_ALIGN
    assert got.dtype == torch.int8 and got.shape == (m, R, kp)
    want = np.asarray(jl.decompose(jnp.asarray(x.T), m, d)).astype(np.int8)
    np.testing.assert_array_equal(got[:, :, :K].numpy(), want)
    assert not got[:, :, K:].any()


def test_host_fusion_bit_exact(rng):
    m, d, K = 2, 7, 256
    A, B = _operands(rng, m, d, K, 16, 16)
    parts = ops.layered_matmul_partials(torch.from_numpy(A),
                                        torch.from_numpy(B), m=m, d=d)
    scales = np.asarray([1 << ((2 * m - 2 - l) * d)
                         for l in range(2 * m - 1)], np.int64)
    recon = (parts.numpy().astype(np.int64)
             * scales[:, None, None]).cumsum(0)[-1]
    exact = A.astype(np.int64).T @ B.astype(np.int64)
    np.testing.assert_array_equal(recon, exact)


def test_fused_wrapper_matches_oracle(rng):
    m, d = 2, 6
    hi = 1 << (m * d - 1)
    A = rng.integers(-hi, hi, size=(64, 32)).astype(np.int32)
    B = rng.integers(-hi, hi, size=(64, 8)).astype(np.int32)
    got = ops.layered_matmul(torch.from_numpy(A), torch.from_numpy(B),
                             m=m, d=d)
    assert got.dtype == torch.float32
    planes_a = np.asarray(jl.decompose(jnp.asarray(A), m, d))
    planes_b = np.asarray(jl.decompose(jnp.asarray(B), m, d))
    want = jref.layered_matmul_ref(planes_a, planes_b, d=d)
    np.testing.assert_array_equal(
        ref.layered_matmul_ref(planes_a, planes_b, d=d), want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.layered_matmul(
            jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True)),
        rtol=1e-6)


def test_fused_wrapper_scales_past_int64_shifts(rng):
    """At m = 6, d = 7 the top layers' scales are 2^70 and 2^63, past an
    int64 shift; negative operands fill the top digit planes, so a wrong
    scale shows in every row.  The port's float32 resolutions equal the
    reference's wrapper's: layer 0's row bit for bit (one product by a
    power of two), the rest to 1e-6 of the row's largest term (the two
    cumulative sums may add in another order)."""
    m, d = 6, 7
    A = rng.integers(-(1 << 30), 0, size=(64, 24)).astype(np.int32)
    B = rng.integers(-(1 << 30), 1 << 30, size=(64, 16)).astype(np.int32)
    got = ops.layered_matmul(torch.from_numpy(A), torch.from_numpy(B),
                             m=m, d=d).numpy()
    want = np.asarray(jops.layered_matmul(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    assert got.shape == want.shape == (2 * m - 1, 24, 16)
    assert np.abs(want[0]).max() > 2.0 ** 70
    np.testing.assert_array_equal(got[0], want[0])
    parts = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    terms = np.abs(parts.astype(np.float64)) * np.asarray(
        [2.0 ** ((2 * m - 2 - l) * d) for l in range(2 * m - 1)]
    )[:, None, None]
    for l in range(2 * m - 1):
        np.testing.assert_allclose(got[l], want[l], rtol=0,
                                   atol=1e-6 * terms[:l + 1].max())


def test_resolution_monotone_improvement(rng):
    m, d = 3, 4
    A = rng.integers(0, 1 << (m * d - 1), size=(32, 16)).astype(np.int32)
    B = rng.integers(0, 1 << (m * d - 1), size=(32, 16)).astype(np.int32)
    res = ops.layered_matmul(torch.from_numpy(A), torch.from_numpy(B),
                             m=m, d=d).numpy()
    exact = A.astype(np.int64).T @ B.astype(np.int64)
    errs = [np.abs(res[l] - exact).max() for l in range(res.shape[0])]
    assert all(a >= b for a, b in zip(errs, errs[1:]))


def test_d_too_large_rejected():
    with pytest.raises(ValueError):
        ops.layered_matmul(torch.zeros((8, 8), dtype=torch.int32),
                           torch.zeros((8, 8), dtype=torch.int32), m=2, d=8)


@pytest.mark.parametrize("m,d,K,M,N", [(3, 5, 100, 20, 33),
                                       (2, 7, 37, 5, 70)])
def test_ragged_shape_against_int64_oracle(rng, m, d, K, M, N):
    """Shapes that divide no tile: the reference would take each odd dim
    as one whole block; the port has no such rule."""
    A, B = _operands(rng, m, d, K, M, N)
    parts = ops.layered_matmul_partials(torch.from_numpy(A),
                                        torch.from_numpy(B), m=m, d=d)
    scales = np.asarray([1 << ((2 * m - 2 - l) * d)
                         for l in range(2 * m - 1)], np.int64)
    res = (parts.numpy().astype(np.int64) * scales[:, None, None]).cumsum(0)
    np.testing.assert_array_equal(
        res, layering.layered_matmul_reference(A, B, m=m, d=d))


def test_out_of_range_operands_wrap_like_reference(rng):
    """Operands beyond ``m*d`` signed bits wrap in the int8 plane cast in
    both packages."""
    m, d = 2, 5
    A = rng.integers(-(1 << 20), 1 << 20, size=(32, 8)).astype(np.int32)
    B = rng.integers(-(1 << 20), 1 << 20, size=(32, 8)).astype(np.int32)
    want = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    got = ops.layered_matmul_partials(torch.from_numpy(A),
                                      torch.from_numpy(B), m=m, d=d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,d", [(4, 4), (5, 3), (8, 2)])
def test_many_planes_match_reference_kernel(rng, m, d):
    """From four planes on (the grouped tensor-core kernel's route on the
    card) the partials equal the reference's Pallas kernel (interpret
    mode) at the same m, bit for bit: the plain version covers any m."""
    A, B = _operands(rng, m, d, 48, 9, 20)
    want = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    got = ops.layered_matmul_partials(torch.from_numpy(A),
                                      torch.from_numpy(B), m=m, d=d)
    assert got.shape == (2 * m - 1, 9, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_partials_past_int32_wrap_like_reference():
    """A layer partial past 2**31 (m = 1, d = 7, K = 140288, every digit
    127: 127**2 K = 2262705152) wraps in the port's plain partials as in
    the reference's int32 accumulation, in its Pallas kernel (interpret
    mode) and in ``layering.layered_matmul_jnp``; a straight float-to-int32
    cast would saturate at -2**31."""
    m, d, K, M, N = 1, 7, 274 * 512, 8, 8
    A = np.full((K, M), 127, np.int32)
    B = np.full((K, N), 127, np.int32)
    wrapped = np.int64(127 * 127 * K - (1 << 32))
    want = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    assert (want == wrapped).all() and wrapped == -2032262144
    got = ops.layered_matmul_partials(torch.from_numpy(A),
                                      torch.from_numpy(B), m=m, d=d)
    np.testing.assert_array_equal(got.numpy(), want)
    got = layering.layered_matmul_torch(torch.from_numpy(A),
                                        torch.from_numpy(B), m=m, d=d)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jl.layered_matmul_jnp(
            jnp.asarray(A), jnp.asarray(B), m=m, d=d)))


def test_kernel_call_keeps_reference_layout_and_errors(rng):
    m, d, K, M, N = 2, 7, 48, 12, 20
    A, B = _operands(rng, m, d, K, M, N)
    pa = np.asarray(jl.decompose(jnp.asarray(A), m, d)).astype(np.int8)
    pb = np.asarray(jl.decompose(jnp.asarray(B), m, d)).astype(np.int8)
    from repro.kernels.layered_matmul import layered_matmul_kernel_call
    want = np.asarray(layered_matmul_kernel_call(
        jnp.asarray(pa), jnp.asarray(pb), m=m, d=d, bm=M, bn=N, bk=K,
        interpret=True))
    got = lm.layered_matmul_kernel_call(torch.from_numpy(pa),
                                        torch.from_numpy(pb), m=m, d=d)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="plane count mismatch"):
        lm.layered_matmul_kernel_call(torch.from_numpy(pa),
                                      torch.from_numpy(pb), m=3, d=d)
    with pytest.raises(TypeError):
        lm.layered_matmul_kmajor(torch.zeros((2, 4, 8), dtype=torch.int32),
                                 torch.zeros((2, 4, 8), dtype=torch.int32),
                                 m=2)


@pytest.mark.parametrize("m,d", [(2, 7), (4, 4)])
def test_cpu_path_never_counts_a_launch(rng, m, d):
    """Neither kernel's count moves on the CPU, whichever kernel
    :func:`kernel_for` would pick on the card."""
    A, B = _operands(rng, m, d, 32, 8, 8)
    before, per_kernel = lm.launches, dict(lm.kernel_launches)
    ops.layered_matmul(torch.from_numpy(A), torch.from_numpy(B), m=m, d=d)
    assert lm.launches == before and lm.kernel_launches == per_kernel
    assert set(lm.kernel_launches) == set(lm.KERNELS)


@pytest.mark.parametrize("m,M,N,K,want", [
    (2, 64, 128256, 4096, "layered_matmul_wgmma"),   # llama3-8b LM head
    (2, 4096, 4096, 4096, "layered_matmul_wgmma"),
    (1, 8, 8, 16, "layered_matmul_wgmma"),
    (3, 200, 328, 1008, "layered_matmul_wgmma"),
    (2, 65, 100, 4112, "layered_matmul_wgmma"),
    (4, 7, 9, 48, "layered_matmul_wgmma_grouped"),
    (4, 4096, 4096, 4096, "layered_matmul_wgmma_grouped"),
    (5, 8, 8, 16, "layered_matmul_wgmma_grouped"),
    (8, 4096, 4096, 4096, "layered_matmul_wgmma_grouped"),
    (40, 200, 328, 1008, "layered_matmul_wgmma_grouped"),
])
def test_layered_routing_by_planes_and_shape(m, M, N, K, want):
    """Up to three planes go to the wgmma kernel, whose L layers of
    64-wide int32 accumulators fit a warpgroup's registers; four and more
    to the grouped wgmma kernel, one group of layers a CTA."""
    assert lm.kernel_for(m, M, N, K) == want
    assert want in lm.KERNELS


def _least_largest_group(J, n, cap):
    """The least largest pair count over every split of the layers (pairs
    ``J``) into ``n`` contiguous groups of at most ``cap`` layers: a
    dynamic program over prefixes, independent of ``group_plan``'s
    search."""
    inf = float("inf")
    best = [[inf] * (len(J) + 1) for _ in range(n + 1)]
    best[0][0] = 0
    for k in range(1, n + 1):
        for end in range(1, len(J) + 1):
            for size in range(1, min(cap, end) + 1):
                prev = best[k - 1][end - size]
                best[k][end] = min(best[k][end],
                                   max(prev, sum(J[end - size:end])))
    return best[n][len(J)]


@pytest.mark.parametrize("m", range(4, 41))
def test_group_plan_runs_every_pair_once(m):
    """``group_plan`` at the grouped wgmma kernel's cap of layers (and at
    a wider one), with one group a CTA and with two (layer-split): every
    plane pair of
    ``layer_minijobs`` falls in exactly one group (the one holding its
    layer), each group's plane ranges are the least that cover its pairs,
    no group holds more layers than the cap allows, the
    CTAs are the fewest that can hold the layers, and their largest pair
    count is the least any such split reaches and at most twice the mean
    (the middle layers hold m pairs each, the ends one: five end layers
    hold 15 pairs however they are grouped)."""
    J = layering.minijobs_per_layer(m)
    L = len(J)
    for per_cta in (1, 2):
        for cap in (lm.GROUP_LAYERS, 5):
            plan = lm.group_plan(m, cap, per_cta=per_cta)
            assert len(plan) % per_cta == 0 and len(plan) <= lm.MAX_GROUPS
            seen = {}
            for g, (l0, l1, a0, a1, b0, b1) in enumerate(plan):
                assert 0 <= l0 and l1 < L and l1 - l0 < cap, (cap, plan)
                if l1 < l0:      # a layer-split CTA's empty second row
                    assert per_cta == 2 and g % 2 and l0 == l1 + 1
                    assert (l1, a0, a1, b0, b1) == (plan[g - 1][1],
                                                    *plan[g - 1][2:])
                    continue
                pairs = [p for l in range(l0, l1 + 1)
                         for p in layering.layer_minijobs(m, l)]
                assert (a0, a1) == (min(i for i, _ in pairs),
                                    max(i for i, _ in pairs))
                assert (b0, b1) == (min(j for _, j in pairs),
                                    max(j for _, j in pairs))
                for p in pairs:
                    assert p not in seen
                    seen[p] = g // per_cta
            assert sorted(seen) == [(i, j) for i in range(m)
                                    for j in range(m)]
            ctas = [(plan[k][0], max(r[1] for r in plan[k:k + per_cta]))
                    for k in range(0, len(plan), per_cta)]
            assert len(ctas) == -(-L // (per_cta * cap))
            sizes = [sum(J[l0:l1 + 1]) for l0, l1 in ctas]
            assert max(sizes) == _least_largest_group(J, len(ctas),
                                                      per_cta * cap)
            assert max(sizes) <= 2 * m * m / len(ctas)


@pytest.mark.parametrize("m,M,want", [(4, 64, 1), (4, 65, 0), (4, 4096, 0),
                                      (5, 4096, 1), (8, 4096, 1),
                                      (40, 8, 1)])
def test_grouped_layout_is_the_measured_one(m, M, want):
    """Stacked for M > 64 at m = 4, layer-split otherwise: the faster of
    the two at the shapes timed on the card.  At the head (m = 4) the
    layer-split plan runs every layer in two CTAs a tile, not three."""
    assert lm.grouped_layout(m, M) == want
    assert want in (lm.STACKED, lm.LAYER_SPLIT)
    if M <= 64 and m == 4:
        assert len(lm.group_plan(m, lm.GROUP_LAYERS, per_cta=2)) == 4
        assert len(lm.group_plan(m, lm.GROUP_LAYERS)) == 3


@pytest.mark.parametrize("m,M,N,K,match", [
    (-1, 8, 8, 16, "m >= 1"),
    (0, 8, 8, 16, "m >= 1"),
    (2, 0, 8, 16, "empty"),
    (2, 8, 0, 16, "empty"),
    (2, 8, 8, 0, "empty"),
])
def test_layered_routing_rejects_what_neither_kernel_takes(m, M, N, K,
                                                           match):
    with pytest.raises(ValueError, match=match):
        lm.kernel_for(m, M, N, K)


@pytest.mark.parametrize("K", [16, 1008, 4112, 37])
def test_kernel_operand_keeps_aligned_planes_and_pads_the_rest(rng, K):
    """What both kernels read: packed planes with K a multiple of 16 as
    they are (TMA zero-fills the wgmma kernel's 128-byte slices past K);
    others as a zero-padded copy whose partials equal the original's."""
    m, d, M, N = 2, 7, 12, 20
    A, B = _operands(rng, m, d, K, M, N)
    pa = layering.decompose(torch.from_numpy(A.T.copy()), m, d).to(torch.int8)
    pb = layering.decompose(torch.from_numpy(B.T.copy()), m, d).to(torch.int8)
    got = lm._kernel_operand(pa)
    if K % lm.K_ALIGN == 0:
        assert got is pa
    else:
        assert got.shape[2] % lm.K_ALIGN == 0 and not got[:, :, K:].any()
    assert torch.equal(got[:, :, :K], pa)
    assert torch.equal(
        lm.layered_matmul_plain(got, lm._kernel_operand(pb), m=m),
        lm.layered_matmul_plain(pa, pb, m=m))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,K,M,N,kernel", [
    (3, 5, 1000, 200, 328, "layered_matmul_wgmma"),
    (2, 7, 1008, 64, 300, "layered_matmul_wgmma"),
])
def test_cuda_kernel_bit_equal_to_jax(rng, hopper, m, d, K, M, N, kernel):
    """The CUDA kernel, launched on the card, against the JAX package's
    Pallas kernel in interpret mode on the host and against its own
    plain version on the card."""
    A, B = _operands(rng, m, d, K, M, N)
    want = np.asarray(jops.layered_matmul_partials(
        jnp.asarray(A), jnp.asarray(B), m=m, d=d, interpret=True))
    before = lm.launches
    per_kernel = dict(lm.kernel_launches)
    got = ops.layered_matmul_partials(torch.from_numpy(A).to(hopper),
                                      torch.from_numpy(B).to(hopper),
                                      m=m, d=d)
    torch.cuda.synchronize()
    assert lm.launches == before + 1
    assert lm.kernel_launches[kernel] == per_kernel[kernel] + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    plain = lm.layered_matmul_plain(
        ops._planes_kmajor(torch.from_numpy(A).to(hopper), m, d),
        ops._planes_kmajor(torch.from_numpy(B).to(hopper), m, d), m=m)
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------------
# flash attention (kernel 2) and the SSD chunk scan (kernel 3), plain on the
# CPU, against the JAX package's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (2, 128, 4, 2, 64, True, None, jnp.float32),
    (1, 256, 2, 1, 32, True, 64, jnp.float32),
    (2, 64, 4, 4, 16, False, None, jnp.float32),
    (1, 512, 2, 2, 128, True, None, jnp.float32),
    (1, 128, 2, 2, 64, True, None, jnp.bfloat16),
    (1, 128, 4, 1, 256, True, 48, jnp.float32),  # recurrentgemma: MQA
    (1, 128, 4, 1, 256, True, 48, jnp.bfloat16),
    (1, 64, 8, 2, 8, True, None, jnp.float32),   # llama4 smoke: dh 8
]


def _t(a):
    """A jax/numpy array as a CPU tensor of the same dtype."""
    from repro_torch.models.convert import array_to_tensor
    return array_to_tensor(np.asarray(a), torch.device("cpu"))


@pytest.mark.parametrize("B,S,H,kv,dh,causal,window,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_interpret(rng, B, S, H, kv, dh, causal,
                                               window, dtype):
    q = jnp.asarray(rng.normal(size=(B, S, H, dh)), dtype)
    k = jnp.asarray(rng.normal(size=(B, S, kv, dh)), dtype)
    v = jnp.asarray(rng.normal(size=(B, S, kv, dh)), dtype)
    want = np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                           window=window, interpret=True),
                      np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 3e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_rows_without_keys_take_the_mean_of_v(rng, dtype):
    """Sq > Skv + window, not causal: rows from Skv + window - 1 on have no
    key inside the window.  The reference's finite mask gives every key
    the same weight there, so such a row is the mean of V (the dh-256
    tensor-core kernel skips key tiles below the window only where no row
    of its tile is like this)."""
    B, Sq, Skv, H, kv, dh, window = 1, 96, 40, 4, 1, 256, 7
    q = jnp.asarray(rng.normal(size=(B, Sq, H, dh)), dtype)
    k = jnp.asarray(rng.normal(size=(B, Skv, kv, dh)), dtype)
    v = jnp.asarray(rng.normal(size=(B, Skv, kv, dh)), dtype)
    want = np.asarray(jops.flash_attention(q, k, v, causal=False,
                                           window=window, interpret=True),
                      np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                              window=window).float().numpy()
    tol = 2e-2 if dtype == jnp.bfloat16 else 3e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    mean_v = np.asarray(v, np.float32).mean(axis=1)          # (B, kv, dh)
    no_key = Skv + window - 1
    np.testing.assert_allclose(got[:, no_key:],
                               np.broadcast_to(mean_v[:, None],
                                               got[:, no_key:].shape),
                               atol=tol, rtol=tol)


def test_flash_plain_matches_host_oracle(rng):
    """The (BH, S, dh) plain version against the float64 NumPy oracle and
    the JAX package's ``flash_attention_ref``."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (rng.normal(size=(6, 96, 32)).astype(np.float32)
               for _ in range(3))
    got = fa.flash_attention_kernel_call(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), window=40)
    np.testing.assert_allclose(got.numpy(),
                               ref.flash_attention_ref(q, k, v, window=40),
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=40)),
        atol=3e-5, rtol=3e-5)


def test_flash_attention_matches_model_attention_layer(rng):
    """The kernel's wrapper agrees with the JAX models' jnp attention."""
    from repro.configs.base import AttentionConfig
    from repro.models.layers import attention
    B, S, H, kv, dh = 2, 128, 4, 2, 32
    cfg = AttentionConfig(num_heads=H, num_kv_heads=kv, head_dim=dh)
    q = jnp.asarray(rng.normal(size=(B, S, H, dh)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(B, S, kv, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, S, kv, dh)), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = np.asarray(attention(q, k, v, pos, pos, cfg))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("B,S,dh", [(1, 64, 16), (2, 128, 32), (3, 256, 64),
                                    (1, 97, 48)])
def test_flash_rows_are_convex_combinations(B, S, dh):
    """Every output is a convex combination of values: bounded by V."""
    rng = np.random.default_rng(S + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, 2, dh))
                                .astype(np.float32)) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.abs().max().item() <= v.abs().max().item() + 1e-4


def test_flash_cpu_path_never_counts_a_launch(rng):
    from repro_torch.kernels import flash_attention as fa
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    before = fa.launches
    ops.flash_attention(q, q, q)
    assert fa.launches == before
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)


@pytest.mark.parametrize("word,module,kernel", [
    pytest.param(0, "flash_attention", "WGMMA_D256", id="0"),
    pytest.param(1, "flash_attention", "WGMMA_D256", id="1"),
    pytest.param(0, "layered_matmul", "WGMMA_GROUPED",
                 id="0-layered_matmul"),
    pytest.param(1, "layered_matmul", "WGMMA_GROUPED",
                 id="1-layered_matmul")])
def test_check_faults_reads_the_d256_give_up_word_once(monkeypatch, word,
                                                       module, kernel):
    """``check_faults`` reads a warp-specialised kernel's give-up word (the
    dh-256 flash kernel's, the grouped layered matmul's) only after a
    launch of that kernel, clears it, and raises ``KernelFault`` where a
    ring wait gave up (the device calls faked: this host has no card)."""
    import contextlib
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    reads = []

    def faults(ref, clear):
        reads.append(clear)
        ref._obj.value = word
        return 0

    monkeypatch.setitem(mod._bound, f"{getattr(mod, kernel)}_faults", faults)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(mod, "_unchecked", set())
    mod.check_faults()
    assert reads == []
    mod._unchecked.add(torch.device("cuda", 0))
    if word:
        with pytest.raises(mod.KernelFault, match="gave up"):
            mod.check_faults()
    else:
        mod.check_faults()
    assert reads == [1] and not mod._unchecked


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 16, "flash_attention"),
    (torch.bfloat16, 48, "flash_attention"),
    (torch.bfloat16, 112, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.float32, 16, "flash_attention"),
    (torch.bfloat16, 256, "flash_attention_wgmma_d256"),
    (torch.float32, 256, "flash_attention"),
    (torch.bfloat16, 8, "flash_attention"),
    (torch.float32, 8, "flash_attention"),
])
def test_flash_routing_by_dtype_and_head_dim(dtype, dh, want):
    """bf16 with dh 64/128 goes to the tensor-core kernel and bf16 with dh
    256 to the dh-256 tensor-core kernel; fp32 (whose 3e-5 TF32 would not
    hold) at every head dim, 256 among them, and the other bf16 head dims,
    8 (padded to 16) among them, to the CUDA-core kernel."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.kernel_for(dtype, dh) == want
    assert want in fa.KERNELS


def test_flash_has_three_kernels_each_with_a_source_and_a_count():
    """Three kernels, each built from ``csrc/<name>.cu`` and counted in
    ``kernel_launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    assert fa.KERNELS == (fa.WGMMA, fa.WGMMA_D256, fa.CUDA_CORE)
    assert len(set(fa.KERNELS)) == 3
    assert set(fa.kernel_launches) == set(fa.KERNELS)
    for name in fa.KERNELS:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()


@pytest.mark.parametrize("kernel,dtype,dh", [
    ("flash_attention_wgmma_d256", torch.bfloat16, 128),
    ("flash_attention_wgmma_d256", torch.float32, 256),
    ("flash_attention_wgmma", torch.bfloat16, 256),
])
def test_flash_forced_tensor_core_kernel_takes_only_its_head_dims(kernel,
                                                                  dtype, dh):
    """A tensor-core kernel named by the caller must be the one
    :func:`kernel_for` picks: the wrapper refuses before any launch."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 2, dh), dtype=dtype)
    before = dict(fa.kernel_launches)
    with pytest.raises(ValueError, match="takes bfloat16 with head dims"):
        fa._launch(q, q, q, True, None, kernel=kernel)
    assert fa.kernel_launches == before


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
    (torch.bfloat16, 512, ValueError),
    (torch.float32, 24, ValueError),
    (torch.bfloat16, 0, ValueError),
])
def test_flash_routing_rejects_what_neither_kernel_takes(dtype, dh, error):
    from repro_torch.kernels import flash_attention as fa
    with pytest.raises(error):
        fa.kernel_for(dtype, dh)


def test_flash_cpu_path_counts_no_launch_of_either_kernel(rng):
    from repro_torch.kernels import flash_attention as fa
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 64))).to(torch.bfloat16)
    before = dict(fa.kernel_launches)
    out = ops.flash_attention(q, q, q)
    assert fa.kernel_launches == before and out.dtype == torch.bfloat16


def test_flash_tma_operand_keeps_packed_tensors_and_copies_the_rest(rng):
    """What the tensor-core route hands to TMA: packed (B, S, H, dh)
    tensors as they are; transposed views and unaligned bases as packed
    copies with the same values.  Size-1 dims get packed strides."""
    from repro_torch.kernels import flash_attention as fa
    x = torch.from_numpy(rng.normal(size=(2, 5, 3, 64))).to(torch.bfloat16)
    assert fa._tma_operand(x) is x
    assert fa._strides(x) == (5 * 3 * 64, 3 * 64, 64)
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    copied = fa._tma_operand(view)
    assert copied is not view and torch.equal(copied, view)
    assert copied.stride() == x.stride()
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    moved = fa._tma_operand(shifted)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)
    one = torch.zeros((1, 5, 1, 64), dtype=torch.bfloat16)
    assert fa._strides(one) == (5 * 64, 64, 64)


SSD_CASES = [
    (2, 48, 4, 8, 16, 16),
    (1, 64, 2, 16, 32, 32),
    (1, 32, 8, 8, 8, 8),
]


def _ssd_inputs(rng, B, S, H, P, N, dt_hi=0.2, unit_a=False):
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, dt_hi, size=(B, S, H)).astype(np.float32)
    A = (-np.ones(H) if unit_a
         else -rng.uniform(0.5, 2.0, size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_matches_jax_interpret(rng, B, S, H, P, N, chunk):
    from repro.models.ssm import ssd_scan
    args = _ssd_inputs(rng, B, S, H, P, N)
    want_y, want_s = jops.ssd_scan_fused(*map(jnp.asarray, args),
                                         chunk=chunk, interpret=True)
    got_y, got_s = ops.ssd_scan_fused(*map(torch.from_numpy, args),
                                      chunk=chunk)
    for got, want in ((got_y, want_y), (got_s, want_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    plain_y, _ = ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(plain_y),
                               rtol=1e-4, atol=1e-4)


def test_ssd_state_carries_across_chunks(rng):
    """One long chunk == the same scan with 4x more chunks."""
    args = tuple(map(torch.from_numpy,
                     _ssd_inputs(rng, 1, 64, 2, 8, 8, dt_hi=0.1,
                                 unit_a=True)))
    y1, s1 = ops.ssd_scan_fused(*args, chunk=64)
    y2, s2 = ops.ssd_scan_fused(*args, chunk=16)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, s2, rtol=1e-4, atol=1e-4)


def test_ssd_init_state_matches_jax_model_scan(rng):
    """The kernel's ``init_state`` (which the TPU kernel lacks) against the
    JAX model's ``ssd_scan(..., init_state)``."""
    from repro.models.ssm import ssd_scan
    B, S, H, P, N, chunk = 2, 48, 4, 8, 16, 16
    args = _ssd_inputs(rng, B, S, H, P, N)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    want_y, want_s = ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                              init_state=jnp.asarray(s0))
    got_y, got_s = ops.ssd_scan_fused(*map(torch.from_numpy, args),
                                      chunk=chunk,
                                      init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)


def test_ssd_kernel_call_layout_and_shape_checks(rng):
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(rng, 1, 32, 2, 8, 8))
    before = ss.launches
    y, _ = ss.ssd_scan_kernel_call(x.reshape(1, 2, 16, 2, 8),
                                   dt.reshape(1, 2, 16, 2), A,
                                   Bm.reshape(1, 2, 16, 8),
                                   Cm.reshape(1, 2, 16, 8))
    assert y.shape == (1, 2, 16, 2, 8) and ss.launches == before
    with pytest.raises(ValueError, match="dt has shape"):
        ss.ssd_scan_kernel_call(x.reshape(1, 2, 16, 2, 8), dt, A,
                                Bm.reshape(1, 2, 16, 8),
                                Cm.reshape(1, 2, 16, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=12)


@pytest.mark.parametrize("dtype,P,N,chunk,want", [
    (torch.bfloat16, 64, 128, 64, "ssd_scan_wgmma"),
    (torch.bfloat16, 64, 128, 128, "ssd_scan_wgmma"),
    (torch.bfloat16, 64, 128, 256, "ssd_scan_wgmma"),
    (torch.float32, 64, 128, 256, "ssd_scan"),
    (torch.float32, 64, 128, 64, "ssd_scan"),
    (torch.bfloat16, 64, 128, 100, "ssd_scan"),
    (torch.bfloat16, 64, 128, 512, "ssd_scan"),
    (torch.bfloat16, 32, 128, 256, "ssd_scan"),
    (torch.bfloat16, 64, 64, 256, "ssd_scan"),
])
def test_ssd_routing_by_dtype_and_shape(dtype, P, N, chunk, want):
    """bf16 x/B/C with mamba2's P = 64, N = 128 and a chunk of 64..256 in
    steps of 64 go to the tensor-core kernel; fp32 (1e-4 on fp32 inputs)
    and the other bf16 shapes to the CUDA-core kernel."""
    from repro_torch.kernels import ssd_scan as ss
    assert ss.kernel_for(dtype, P, N, chunk) == want
    assert want in ss.KERNELS


@pytest.mark.parametrize("dtype,P,N,error", [
    (torch.float16, 64, 128, TypeError),
    (torch.float64, 64, 128, TypeError),
    (torch.bfloat16, 64, 256, ValueError),
    (torch.float32, 128, 128, ValueError),
    (torch.bfloat16, 64, 126, ValueError),
])
def test_ssd_routing_rejects_what_neither_kernel_takes(dtype, P, N, error):
    from repro_torch.kernels import ssd_scan as ss
    with pytest.raises(error):
        ss.kernel_for(dtype, P, N, 256)


def test_ssd_cpu_path_counts_no_launch_of_either_kernel(rng):
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(rng, 1, 128, 2, 64, 128))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    before, per_kernel = ss.launches, dict(ss.kernel_launches)
    y, state = ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=64)
    assert ss.launches == before and ss.kernel_launches == per_kernel
    assert y.dtype == state.dtype == torch.float32


def test_ssd_bf16_inputs_match_jax_interpret(rng):
    """bf16 x/B/C, as the model hands them to the scan, at mamba2's head
    and state widths: the port's wrapper on the host against the JAX
    package's Pallas kernel in interpret mode on the same values."""
    args = list(_ssd_inputs(rng, 1, 256, 2, 64, 128))
    for i in (0, 3, 4):           # x, B, C rounded to bf16 for both sides
        args[i] = torch.from_numpy(args[i]).to(torch.bfloat16)
    want_y, want_s = jops.ssd_scan_fused(
        *(jnp.asarray(a.float().numpy() if torch.is_tensor(a) else a)
          for a in args), chunk=64, interpret=True)
    got_y, got_s = ops.ssd_scan_fused(
        *(a if torch.is_tensor(a) else torch.from_numpy(a) for a in args),
        chunk=64)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)


def _bf16_terms(v, terms):
    """``v`` as ``terms`` bf16 values, each the rounded rest of the ones
    before it: the tensor-core SSD kernel's split of an fp32 operand."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        v = v - t
    return out


def _split_scan(x, dt, A, Bm, Cm, init, terms):
    """The tensor-core SSD kernel's arithmetic in plain PyTorch, in its two
    passes: every product whose operands are bf16 (C B^T) as it is; each
    product with an fp32 operand (W = (C B^T) o L o dt_j against x, C
    against the state, x o dt exp(acum[-1] - acum) against B) once per bf16
    term of that operand, the products summed in fp32.  ``terms`` gives the
    number of terms of W, of the state and of x o w, in that order."""
    t_w, t_state, t_xw = terms
    f32 = torch.float32
    Bsz, nc, l, H, P = x.shape
    x, Bm, Cm = (t.to(f32) for t in (x, Bm, Cm))
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
    state = (torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=f32)
             if init is None else init.clone())
    states, acums = [], []
    for c in range(nc):                       # pass 1: the state
        states.append(state)
        acum = torch.cumsum(A * dt[:, c], dim=1)                   # (B, l, H)
        acums.append(acum)
        w = dt[:, c] * torch.exp(acum[:, -1:] - acum)
        contrib = sum(torch.einsum("bjhp,bjn->bhpn", t, Bm[:, c])
                      for t in _bf16_terms(x[:, c] * w[..., None], t_xw))
        state = state * torch.exp(acum[:, -1])[:, :, None, None] + contrib
    ys = []
    for c in range(nc):                       # pass 2: the outputs
        acum = acums[c]
        diff = acum[:, :, None, :] - acum[:, None, :, :]           # (B,i,j,H)
        L = torch.where(causal[None, :, :, None], torch.exp(diff),
                        torch.zeros((), dtype=f32))
        S = torch.einsum("bin,bjn->bij", Cm[:, c], Bm[:, c])
        W = S[..., None] * L * dt[:, c][:, None]
        y = sum(torch.einsum("bijh,bjhp->bihp", t, x[:, c])
                for t in _bf16_terms(W, t_w))
        y_off = sum(torch.einsum("bin,bhpn->bihp", Cm[:, c], t)
                    for t in _bf16_terms(states[c], t_state))
        ys.append(y + y_off * torch.exp(acum)[..., None])
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("terms,init,holds", [
    ((3, 3, 3), False, True), ((3, 3, 3), True, True),
    ((1, 1, 1), False, False), ((1, 1, 1), True, False),
    ((3, 2, 2), False, True), ((3, 2, 2), True, True)])
def test_ssd_bf16_split_error_budget(terms, init, holds):
    """The tensor-core kernel's error budget, on the host: with each fp32
    operand split into three bf16 terms (the kernel's choice), the scan at
    mamba2's head and state widths (B=1, S=512, H=2, P=64, N=128, chunk
    256) matches the plain version on the same bf16 inputs within the
    card's atol = rtol = 1e-4; with one term it does not.  Two terms for
    the state products (C s^T and (x o w)^T B) hold it too.  Inputs are
    drawn as ``chip_smoke.py`` draws them."""
    from repro_torch.kernels import ssd_scan as ss
    r = np.random.default_rng(3)
    B, S, H, P, N, chunk = 1, 512, 2, 64, 128, 256
    nc = S // chunk
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(r.normal(size=(B, nc, chunk, H, P)))
    dt = torch.from_numpy(
        r.uniform(0.01, 0.2, size=(B, nc, chunk, H)).astype(np.float32))
    A = -torch.from_numpy(r.uniform(0.5, 2.0, size=(H,)).astype(np.float32))
    Bm = bf(r.normal(size=(B, nc, chunk, N)))
    Cm = bf(r.normal(size=(B, nc, chunk, N)))
    s0 = (torch.from_numpy(r.normal(size=(B, H, P, N)).astype(np.float32))
          if init else None)
    want_y, want_s = ss.ssd_scan_plain(x, dt, A, Bm, Cm, s0)
    got_y, got_s = _split_scan(x, dt, A, Bm, Cm, s0, terms)
    close = (torch.allclose(got_y, want_y, atol=1e-4, rtol=1e-4)
             and torch.allclose(got_s, want_s, atol=1e-4, rtol=1e-4))
    assert close == holds, (terms, (got_y - want_y).abs().max().item(),
                            (got_s - want_s).abs().max().item())


# -- the SSD scan's backward (its kernel's plain twin, the dispatch rule) ----

def _twin_case(rng, dtype, init, dstate, B=2, S=48, H=3, P=8, N=16,
               chunk=16):
    """Chunked inputs in ``dtype``, the plain scan's gradients by autograd
    for seeded cotangents (of y, and of the final state with ``dstate``),
    and the twin's on the same inputs and cotangents."""
    from repro_torch.kernels import ssd_scan as ss
    nc = S // chunk
    t = lambda a: torch.tensor(a, dtype=dtype)
    x, dt, A, Bm, Cm = (t(a) for a in _ssd_inputs(rng, B, S, H, P, N))
    args = [x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), A,
            Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N)]
    if init:
        args.append(t(rng.normal(size=(B, H, P, N))))
    args = [a.requires_grad_() for a in args]
    y, state, states = ss.ssd_scan_plain(*args[:5], args[5] if init else None,
                                         keep_states=True)
    dy = t(rng.normal(size=y.shape))
    ds = t(rng.normal(size=state.shape)) if dstate else None
    want = torch.autograd.grad([y] + ([state] if dstate else []), args,
                               [dy] + ([ds] if dstate else []))
    got = ss.ssd_scan_backward_plain(*(a.detach() for a in args[:5]),
                                     states.detach(), dy, ds)
    return got[:5] + ((got[5],) if init else ()), want


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dstate", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_ssd_backward_twin_equals_autograd_of_the_plain_scan(rng, init,
                                                             dstate, dtype,
                                                             tol):
    """``ssd_scan_backward_plain``, the backward kernel's arithmetic in
    PyTorch (the reverse state pass, the chunk pass, the decay gradients'
    reverse cumsum), against autograd of ``ssd_scan_plain``: 1e-10 in
    float64, 1e-5 relative to each gradient's largest value in float32
    (the two sum in different orders)."""
    got, want = _twin_case(rng, dtype, init, dstate)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        scale = w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype,P,N,chunk", [
    (torch.bfloat16, 64, 128, 64), (torch.bfloat16, 64, 128, 128),
    (torch.bfloat16, 64, 128, 256), (torch.float32, 64, 128, 256),
    (torch.float32, 64, 128, 64), (torch.bfloat16, 64, 128, 100),
    (torch.bfloat16, 64, 128, 512), (torch.bfloat16, 32, 128, 256),
    (torch.bfloat16, 64, 64, 256)])
def test_ssd_backward_routing_follows_the_forwards(dtype, P, N, chunk):
    """The backward kernel takes exactly the inputs that ``kernel_for``
    sends to the tensor-core forward (whose chunk states it reads); the
    others keep the plain recompute (None)."""
    from repro_torch.kernels import ssd_scan as ss
    want = ss.BACKWARD if ss.kernel_for(dtype, P, N, chunk) == ss.WGMMA \
        else None
    assert ss.backward_kernel_for(dtype, P, N, chunk) == want


@pytest.mark.parametrize("dtype,P,N,error", [
    (torch.float16, 64, 128, TypeError),
    (torch.float64, 64, 128, TypeError),
    (torch.bfloat16, 64, 256, ValueError),
    (torch.float32, 128, 128, ValueError)])
def test_ssd_backward_routing_rejects_as_the_forwards(dtype, P, N, error):
    from repro_torch.kernels import ssd_scan as ss
    with pytest.raises(error):
        ss.backward_kernel_for(dtype, P, N, 256)


def _ssd_fused_args(rng, B=2, S=32, H=3, P=8, N=16, dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in
                        _ssd_inputs(rng, B, S, H, P, N))
    return [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)]


def test_ssd_cpu_backward_counts_no_backward_launch(rng):
    """On the CPU the scan's gradient is the plain recompute's: no launch
    on either counter, forward or backward."""
    from repro_torch.kernels import ssd_scan as ss
    args = [a.requires_grad_() for a in
            _ssd_fused_args(rng, S=128, P=64, N=128, dtype=torch.bfloat16)]
    before = (ss.launches, ss.backward_launches,
              dict(ss.backward_kernel_launches))
    y, state = ops.ssd_scan_fused(*args, chunk=64)
    torch.autograd.grad(y.sum() + state.sum(), args)
    assert (ss.launches, ss.backward_launches,
            dict(ss.backward_kernel_launches)) == before


@pytest.mark.parametrize("remat", [False, True])
def test_ssd_backward_kernel_route_on_the_cpu_equals_the_recompute(
        rng, monkeypatch, remat):
    """The backward kernel's route through ``ops._SSDScan`` (the forward
    keeping its chunk states, ``ssd_scan_backward_call``, the gradients
    laid out as the inputs), taken on the CPU, where the call runs the
    kernel's plain twin: equal to the plain recompute's gradients, also
    under ``torch.utils.checkpoint`` (remat reads the saved tensors
    once)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.ssm import ssd_scan
    base = _ssd_fused_args(rng)
    s0 = torch.tensor(rng.normal(size=(2, 3, 8, 16)), dtype=torch.float32)
    dy = torch.tensor(rng.normal(size=(2, 32, 3, 8)), dtype=torch.float32)

    def grads(fn):
        args = [a.clone().requires_grad_() for a in base + [s0]]
        y = (checkpoint(fn, *args, use_reentrant=False) if remat
             else fn(*args))
        return torch.autograd.grad(y, args, dy)

    want = grads(lambda *a: ssd_scan(*a[:5], 8, a[5])[0])
    monkeypatch.setattr(ops, "_ssd_backward_kernel", lambda *a: True)
    got = grads(lambda *a: ops.ssd_scan_fused(*a[:5], chunk=8,
                                              init_state=a[5])[0])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


def test_ssd_backward_on_fake_tensors_gives_the_gradients_shapes():
    """Under ``FakeTensorMode`` (``launch.op_costs``) the backward runs no
    recompute: it returns empty gradients shaped like the inputs that need
    one, and the cost pass counts the step at the
    forward's and the backward kernel's own work
    (``ss.flops`` + ``ss.backward_flops``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import op_costs
    B, S, H, P, N, chunk = 2, 512, 4, 64, 128, 256
    out = {}

    def step(x, dt, A, Bm, Cm):
        y, _ = ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=chunk)
        out["grads"] = torch.autograd.grad(y, (x, dt, A, Bm),
                                           torch.ones_like(y))

    with FakeTensorMode():
        bf = torch.bfloat16
        args = (torch.empty((B, S, H, P), dtype=bf, requires_grad=True),
                torch.empty((B, S, H), requires_grad=True),
                torch.empty((H,), requires_grad=True),
                torch.empty((B, S, 1, N), dtype=bf, requires_grad=True),
                torch.empty((B, S, 1, N), dtype=bf))
        costs = op_costs.module_costs(step, *args)
    grads = out["grads"]
    assert [(tuple(g.shape), g.dtype) for g in grads] == [
        ((B, S, H, P), bf), ((B, S, H), torch.float32),
        ((H,), torch.float32), ((B, S, 1, N), bf)]
    nc = S // chunk
    kernels = (ss.flops(B, nc, chunk, H, P, N)
               + ss.backward_flops(B, nc, chunk, H, P, N))
    assert kernels <= costs.flops < 1.01 * kernels


# ---------------------------------------------------------------------------
# Decode attention (one token against a KV cache)
# ---------------------------------------------------------------------------

def _parent_decode_attention(q, k_cache, v_cache, pos, cfg, cache_len):
    """``models.layers.decode_attention`` as it was before the kernel: the
    grouped fp32 logits over every slot, a bias mask, softmax in fp32."""
    from repro_torch.models import layers as L
    B, _, H, Dh = q.shape
    S = k_cache.shape[1]
    qg = L.group_heads(q, cfg.num_kv_heads)
    slots = torch.arange(S, dtype=torch.int64, device=q.device)[None, :]
    valid = slots < cache_len[:, None]
    if cfg.window is not None:
        valid = valid & (slots > (pos[:, None] - cfg.window))
    bias = torch.where(valid, 0.0, L._NEG_INF)[:, None, None, None, :]
    out = L._attend(qg, k_cache, v_cache, bias, cfg.attn_logit_softcap)
    return out.reshape(B, 1, H, Dh)


def _decode_case(rng, B, S, H, kv, dh, dtype):
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dtype) for shape in ((B, 1, H, dh), (B, S, kv, dh),
                                        (B, S, kv, dh)))
    length = torch.from_numpy(rng.integers(1, S + 1, size=B))
    return q, k, v, length - 1, length


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,kv,dh,window,softcap", [
    (4, 2, 16, None, None), (8, 8, 8, None, None), (8, 1, 16, 5, None),
    (32, 4, 32, None, 30.0), (12, 3, 16, 7, 20.0)])
def test_decode_attention_on_the_cpu_equals_the_parents_path(
        rng, monkeypatch, dtype, H, kv, dh, window, softcap):
    """On CPU tensors ``ops.decode_attention`` (and
    ``models.layers.decode_attention`` through it) is the parent's plain
    path bit for bit, at ragged cache lengths, and launches nothing."""
    from repro_torch.configs.base import AttentionConfig
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import layers as L

    def kernel(*args, **kw):
        raise AssertionError("the kernel ran on CPU tensors")

    monkeypatch.setattr(da, "decode_attention_kernel_call", kernel)
    cfg = AttentionConfig(num_heads=H, num_kv_heads=kv, head_dim=dh,
                          window=window, attn_logit_softcap=softcap)
    q, k, v, pos, length = _decode_case(rng, 3, 40, H, kv, dh, dtype)
    want = _parent_decode_attention(q, k, v, pos, cfg, length)
    before = da.launches
    got = ops.decode_attention(q, k, v, pos, length, window=window,
                               softcap=softcap)
    assert da.launches == before
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(L.decode_attention(q, k, v, pos, cfg, length), want)


def test_decode_attention_records_its_range_under_the_profiler(rng):
    """Each call is one ``repro.kernel.decode_attention`` range while the
    profiler records."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, pos, length = _decode_case(rng, 2, 24, 4, 2, 16, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            ops.decode_attention(q, k, v, pos, length)
    names = [e.name for e in prof.events() if e.name.startswith("repro.")]
    assert names == ["repro.kernel.decode_attention"] * 3


def test_decode_attention_on_a_dtensor_takes_the_plain_path(rng,
                                                            monkeypatch):
    """A DTensor cache split over the slots of a context-parallel mesh (here
    one rank) takes the plain version: the same values as on plain
    tensors, never the kernel, and a DTensor out."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import mesh as mesh_lib

    def kernel(*args, **kw):
        raise AssertionError("the kernel ran on a DTensor")

    monkeypatch.setattr(da, "decode_attention_kernel_call", kernel)
    q, k, v, pos, length = _decode_case(rng, 2, 24, 4, 2, 16, torch.float32)
    want = da.decode_attention_plain(q, k, v, pos, length, 5)
    assert not dist.is_initialized()
    try:
        mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
        qd = DTensor.from_local(q, mesh, [Replicate(), Replicate()],
                                run_check=False)
        kd, vd = (DTensor.from_local(t, mesh, [Replicate(), Shard(1)],
                                     run_check=False) for t in (k, v))
        # positions stay plain tensors, as the sharded cells pass them
        got = ops.decode_attention(qd, kd, vd, pos, length, window=5)
        assert isinstance(got, DTensor)
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 8, "simt")])
def test_decode_attention_routing_by_dtype_and_head_dim(dtype, dh, want):
    """bf16 at head dim 64 or 128 takes the tensor cores; fp32 and the
    other head dims the CUDA cores."""
    from repro_torch.kernels import decode_attention as da
    assert da.route_for(dtype, dh) == want


@pytest.mark.parametrize("B,S,H,kv,want", [
    (32, 1152, 32, 4, 1),      # yi-6b.chat: 128 pairs
    (4, 4112, 32, 4, 8),       # yi-6b.long-prompt: 16 pairs
    (32, 1152, 32, 8, 1),      # granite-4.0-h-small.chat: 256 pairs
    (4, 1040, 32, 8, 4),       # llama3-8b served at 4 x 1024: 32 pairs
    (1, 100, 8, 1, 2),         # few slots: no more splits than tiles
    (1, 100000, 8, 1, 128)])   # many slots, one pair: the cap
def test_decode_attention_splits_follow_pairs_and_slots(B, S, H, kv, want):
    """About one CTA an SM of an H100's 132: the splits of the cache's
    positions follow batch x kv heads x 16-row tiles and the capacity."""
    from repro_torch.kernels import decode_attention as da
    pairs = B * kv * -(-(H // kv) // da.ROWS)
    assert da.splits_for(pairs, S, da.MMA, 132) == want


def test_decode_attention_bound_reads_the_valid_cache_once():
    """``min_bytes`` at yi-6b.chat with every slot valid: K and V of 32
    rows x 1152 slots x 4 kv heads x 128 at bf16 (75.5 MB), the query and
    the output."""
    from repro_torch.kernels import decode_attention as da
    kv_bytes = 2 * 32 * 1152 * 4 * 128 * 2
    assert da.min_bytes(32 * 1152, 4, 128, 32, 32, 2) == \
        kv_bytes + 2 * 32 * 32 * 128 * 2
    assert kv_bytes == 75_497_472
