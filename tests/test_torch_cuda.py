"""The port's CUDA kernels against their plain versions, on the card.

The layered int8 matmul, flash attention and the SSD chunk scan, and the
smoke models through them against the host; last, the one-rank NCCL mesh
(the layered all-reduce and the distributed coded matmul on the card, and
the sharded prefill and train cells launching the kernels).  These tests need an NVIDIA
Hopper GPU and ``nvcc``; elsewhere they skip.
They import nothing of JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU-side checks of the same wrappers are in ``test_torch_kernels.py``
(which needs JAX).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import layering  # noqa: E402
from repro_torch.kernels import layered_matmul as lm  # noqa: E402
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


def _planes(rng, m, d, K, R, dev):
    hi = 1 << (m * d - 1)
    x = torch.from_numpy(rng.integers(-hi, hi, size=(K, R)).astype(np.int32))
    return x, ops._planes_kmajor(x, m, d).to(dev)


WGMMA, MMA_SYNC, GROUPED = lm.WGMMA, lm.MMA_SYNC, lm.GROUPED
WGMMA_GROUPED = lm.WGMMA_GROUPED


@pytest.mark.parametrize("m,d,K,M,N,kernel", [
    (2, 7, 1024, 128, 128, WGMMA), (3, 5, 1000, 200, 328, WGMMA),
    (4, 4, 33, 7, 9, WGMMA_GROUPED), (1, 7, 16, 8, 8, WGMMA),
    (2, 7, 4096, 64, 1000, WGMMA),
    (2, 7, 4096, 64, 128256, WGMMA),     # the llama3-8b LM head
    (2, 7, 4112, 64, 300, WGMMA),        # K tail of 16 bytes past 128s
    (2, 7, 1008, 200, 300, WGMMA),       # K short of a 128-byte slice
    (2, 7, 256, 65, 100, WGMMA),         # two row tiles, N below one tile
    (3, 5, 4112, 65, 200, WGMMA),
    (1, 7, 1008, 200, 1000, WGMMA),
    (4, 4, 1008, 200, 300, WGMMA_GROUPED)])
def test_kernel_bit_equal_to_plain(rng, hopper, m, d, K, M, N, kernel):
    a, pa = _planes(rng, m, d, K, M, hopper)
    b, pb = _planes(rng, m, d, K, N, hopper)
    before = lm.launches
    per_kernel = dict(lm.kernel_launches)
    got = lm.layered_matmul_kmajor(pa, pb, m=m)
    lm.check_faults()
    assert lm.launches == before + 1
    assert lm.kernel_launches[kernel] == per_kernel[kernel] + 1
    want = lm.layered_matmul_plain(pa, pb, m=m)
    assert torch.equal(got, want)
    # the scaled partials sum to the exact product; float64 on the card is
    # exact here (|a b| summed over K stays below 2**53)
    scales = torch.tensor([1 << ((2 * m - 2 - l) * d)
                           for l in range(2 * m - 1)], dtype=torch.int64,
                          device=hopper)
    full = (got.to(torch.int64) * scales[:, None, None]).sum(0)
    exact = a.to(hopper, torch.float64).T @ b.to(hopper, torch.float64)
    assert torch.equal(full, exact.to(torch.int64))


@pytest.mark.parametrize("m,d,K,R", [(2, 7, 4096, 300), (3, 5, 37, 70),
                                     (1, 7, 16, 3)])
def test_kmajor_planes_on_card_equal_host(rng, hopper, m, d, K, R):
    """The ops wrapper's planes are the same on the card as on the host,
    where they are held against the reference; operands beyond ``m*d``
    bits wrap alike."""
    x = torch.from_numpy(
        rng.integers(-(1 << 20), 1 << 20, size=(K, R)).astype(np.int32))
    assert torch.equal(ops._planes_kmajor(x.to(hopper), m, d).cpu(),
                       ops._planes_kmajor(x, m, d))


@pytest.mark.parametrize("K", [64, 37])
def test_unaligned_or_unpadded_planes_are_copied_exactly(rng, hopper, K):
    """Planes that start off a 16-byte boundary, or whose K is no multiple
    of 16, reach the kernel through a zero-padded copy and stay exact."""
    m, d, M, N = 2, 7, 16, 24
    hi = 1 << (m * d - 1)
    a = torch.from_numpy(rng.integers(-hi, hi, size=(M, K)).astype(np.int32))
    pa = layering.decompose(a, m, d).to(torch.int8).to(hopper)
    _, pb = _planes(rng, m, d, K, N, hopper)
    pb = pb[:, :, :K]
    buf = torch.empty(pa.numel() + 1, dtype=torch.int8, device=hopper)
    shifted = buf[1:].view(pa.shape)
    shifted.copy_(pa)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = lm.launches
    per_kernel = dict(lm.kernel_launches)
    got = lm.layered_matmul_kmajor(shifted, pb, m=m)
    assert lm.launches == before + 1
    assert lm.kernel_launches[WGMMA] == per_kernel[WGMMA] + 1
    assert torch.equal(got, lm.layered_matmul_plain(pa, pb, m=m))


def test_fused_wrapper_on_card_matches_oracle(rng, hopper):
    m, d = 2, 6
    hi = 1 << (m * d - 1)
    A = rng.integers(-hi, hi, size=(256, 64))
    B = rng.integers(-hi, hi, size=(256, 40))
    got = ops.layered_matmul(torch.from_numpy(A).to(hopper),
                             torch.from_numpy(B).to(hopper), m=m, d=d)
    np.testing.assert_allclose(
        got.cpu().numpy(), layering.layered_matmul_reference(A, B, m=m, d=d),
        rtol=1e-6)


@pytest.mark.parametrize("m,M,N,kernel", [(1, 4, 16, WGMMA),
                                          (4, 4, 16, MMA_SYNC),
                                          (5, 4, 16, GROUPED),
                                          (4, 4, 16, WGMMA_GROUPED),
                                          (5, 4, 16, WGMMA_GROUPED)])
def test_kernels_wrap_past_int32_like_plain(hopper, m, M, N, kernel):
    """Every digit 127 over K = 140288: each plane product is 127**2 K =
    2262705152, past 2**31.  The kernels accumulate in int32 without
    saturation (no ``.satfinite``), so they wrap, as the reference's
    int32 accumulation and the plain version do.  The routed kernels are
    reached through the wrapper, the earlier routes through ``_launch``."""
    K = 274 * 512
    pa = torch.full((m, M, K), 127, dtype=torch.int8, device=hopper)
    pb = torch.full((m, N, K), 127, dtype=torch.int8, device=hopper)
    before = lm.kernel_launches[kernel]
    if kernel == lm.kernel_for(m, M, N, K):
        got = lm.layered_matmul_kmajor(pa, pb, m=m)
    else:
        got = lm._launch(pa, pb, m, kernel=kernel)
    lm.check_faults()
    assert lm.kernel_launches[kernel] == before + 1
    want = lm.layered_matmul_plain(pa, pb, m=m)
    assert torch.equal(got, want)
    if m == 1:
        assert (got == -2032262144).all()


@pytest.mark.parametrize("m,M,N,K", [
    (5, 200, 328, 1008), (6, 65, 100, 4112), (7, 7, 9, 48),
    (8, 200, 328, 1008), (5, 4096, 4096, 4096), (8, 4096, 4096, 4096),
    (4, 200, 328, 1008), (4, 4096, 4096, 4096)])
def test_many_planes_match_plain(hopper, m, M, N, K):
    """From four planes on the grouped tensor-core kernel (a group of at
    most three layers a consumer) gives the plain version's partials bit
    for bit, ragged and at 4096^3, in the layout it routes to and in the
    other; so does the grouped mma.sync kernel, its earlier route; the two
    register-resident kernels refuse what they were not built for."""
    gen = torch.Generator(device=hopper).manual_seed(m * 1000 + M)
    pa = torch.randint(-128, 128, (m, M, K), generator=gen,
                       device=hopper).to(torch.int8)
    pb = torch.randint(-128, 128, (m, N, K), generator=gen,
                       device=hopper).to(torch.int8)
    want = lm.layered_matmul_plain(pa, pb, m=m)
    before = lm.kernel_launches[WGMMA_GROUPED]
    got = lm.layered_matmul_kmajor(pa, pb, m=m)
    lm.check_faults()
    assert lm.kernel_launches[WGMMA_GROUPED] == before + 1
    assert torch.equal(got, want)
    other = 1 - lm.grouped_layout(m, M)
    assert torch.equal(lm._launch(pa, pb, m, kernel=WGMMA_GROUPED,
                                  layout=other), want)
    lm.check_faults()
    assert torch.equal(lm._launch(pa, pb, m, kernel=GROUPED), want)
    z = torch.zeros((m, 8, 16), dtype=torch.int8, device=hopper)
    if m > lm.MMA_SYNC_MAX_PLANES:
        with pytest.raises(ValueError, match="m <= 4"):
            lm._launch(z, z, m, kernel=MMA_SYNC)
    with pytest.raises(ValueError, match="m <= 3"):
        lm._launch(z, z, m, kernel=WGMMA)


@pytest.mark.parametrize("m,d,K,M,N", [
    (4, 3, 4096, 64, 128256),    # the llama3-8b LM head at m = 4
    (4, 3, 37, 16, 24), (5, 3, 37, 70, 130), (4, 3, 1000, 64, 300)])
def test_grouped_kernel_at_the_head_and_on_unaligned_planes(rng, hopper, m,
                                                            d, K, M, N):
    """The grouped tensor-core kernel at the m = 4 LM head, and on planes
    that start off a 16-byte boundary or whose K is no multiple of 16
    (they reach it through a zero-padded copy), bit for bit against the
    plain version, as the m <= 3 case above."""
    _, pa = _planes(rng, m, d, K, M, hopper)
    _, pb = _planes(rng, m, d, K, N, hopper)
    if K % 16 == 0:
        shifted = pa
    else:
        pa = pa[:, :, :K]
        pb = pb[:, :, :K]
        buf = torch.empty(pa.numel() + 1, dtype=torch.int8, device=hopper)
        shifted = buf[1:].view(pa.shape)
        shifted.copy_(pa)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = lm.launches
    per_kernel = dict(lm.kernel_launches)
    got = lm.layered_matmul_kmajor(shifted, pb, m=m)
    lm.check_faults()
    assert lm.launches == before + 1
    assert lm.kernel_launches[WGMMA_GROUPED] == (
        per_kernel[WGMMA_GROUPED] + 1)
    assert torch.equal(got, lm.layered_matmul_plain(pa, pb, m=m))


def test_fused_wrapper_on_card_equals_cpu_past_int64_shifts(rng, hopper):
    """``ops.layered_matmul`` at m = 6, d = 7 (scales 2^70 and 2^63 on
    the top layers) on negative operands: the card's float32 resolutions
    equal the CPU wrapper's, layer 0's row bit for bit (the same exact
    partials times the same power of two), the rest to 1e-6 of the row's
    largest term (the two cumulative sums may add in another order)."""
    m, d = 6, 7
    A = torch.from_numpy(rng.integers(-(1 << 30), 0, size=(64, 24))
                         .astype(np.int32))
    B = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, size=(64, 16))
                         .astype(np.int32))
    want = ops.layered_matmul(A, B, m=m, d=d)
    got = ops.layered_matmul(A.to(hopper), B.to(hopper), m=m, d=d).cpu()
    assert want[0].abs().max() > 2.0 ** 70
    assert torch.equal(got[0], want[0])
    terms = ops.layered_matmul_partials(A, B, m=m, d=d).double().abs() \
        * torch.tensor([2.0 ** ((2 * m - 2 - l) * d)
                        for l in range(2 * m - 1)],
                       dtype=torch.float64)[:, None, None]
    for l in range(2 * m - 1):
        assert (got[l] - want[l]).abs().max() <= 1e-6 * terms[:l + 1].max()


# ---------------------------------------------------------------------------
# flash attention (kernel 2) and the SSD chunk scan (kernel 3)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, H, kv, dh, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, None, torch.float32),
    (1, 100, 100, 2, 1, 32, True, 7, torch.float32),     # ragged + window
    (2, 64, 64, 4, 4, 16, False, None, torch.float32),
    (1, 512, 512, 2, 2, 128, True, None, torch.float32),
    (1, 128, 128, 2, 2, 64, True, None, torch.bfloat16),
    (2, 257, 257, 8, 2, 128, True, 64, torch.bfloat16),  # GQA, ragged
    (1, 33, 77, 4, 2, 48, False, None, torch.float32),   # Sq != Skv
    (1, 8, 8, 4, 1, 16, False, None, torch.float32),
    # bf16 on the tensor-core kernel (dh 64 and 128)
    (1, 1024, 1024, 32, 8, 128, True, None, torch.bfloat16),  # llama3-8b
    (1, 33, 77, 4, 2, 64, False, None, torch.bfloat16),  # Sq != Skv
    (2, 300, 300, 4, 2, 128, True, 7, torch.bfloat16),   # first tiles masked
    (1, 200, 200, 4, 2, 64, False, 7, torch.bfloat16),   # window, no causal
    (2, 256, 256, 8, 1, 64, True, None, torch.bfloat16),  # kv = 1 (MQA)
    (1, 257, 257, 4, 4, 128, True, None, torch.bfloat16),  # ragged
    (2, 100, 100, 4, 2, 64, True, None, torch.bfloat16),   # ragged
    (1, 77, 300, 4, 2, 128, True, None, torch.bfloat16),   # Sq < Skv
    (1, 300, 130, 4, 2, 128, True, None, torch.bfloat16),  # Sq > Skv
    # bf16 with another head dim stays on the CUDA-core kernel
    (1, 100, 100, 4, 2, 32, True, None, torch.bfloat16),
    # head dim 256 in bf16 on its tensor-core kernel: recurrentgemma-9b's
    # MQA with a ragged S and a binding window, a GQA group of 2, H = n_kv
    # (two row tiles of one head per CTA, the second past Sq), non-causal,
    # Sq != Skv both ways (the second with rows that keep no key in their
    # window), and S = 4096 with window 2048 (key tiles skipped on both
    # sides)
    (1, 300, 300, 16, 1, 256, True, 100, torch.bfloat16),
    (2, 200, 200, 4, 2, 256, True, None, torch.bfloat16),
    (1, 257, 257, 2, 2, 256, True, None, torch.bfloat16),
    (2, 130, 130, 4, 1, 256, False, None, torch.bfloat16),
    (1, 77, 300, 4, 2, 256, True, None, torch.bfloat16),
    (1, 300, 130, 4, 1, 256, False, 7, torch.bfloat16),
    (1, 4096, 4096, 16, 1, 256, True, 2048, torch.bfloat16),
    # head dim 256 in fp32 and head dim 8 (llama4-maverick's smoke config,
    # padded to 16) on the CUDA-core kernel
    (1, 300, 300, 16, 1, 256, True, 100, torch.float32),
    (2, 130, 130, 4, 2, 256, False, None, torch.float32),
    (2, 100, 100, 8, 2, 8, True, None, torch.bfloat16),
    (1, 77, 77, 8, 2, 8, True, 16, torch.float32),
    # whisper-tiny: the encoder's non-causal self-attention (Skv = 1500,
    # no multiple of the 64-key tile) and the decoder's cross-attention
    # to it; internvl2-1b's GQA group of 7 (H = 14, kv = 2), causal
    (1, 1500, 1500, 6, 6, 64, False, None, torch.bfloat16),
    (4, 1024, 1500, 6, 6, 64, False, None, torch.bfloat16),
    (4, 1024, 1024, 14, 2, 64, True, None, torch.bfloat16),
    (1, 300, 300, 14, 2, 64, True, None, torch.bfloat16),
]


def _flash_inputs(rng, B, Sq, Skv, H, kv, dh, dtype, dev, q_scale=1.0):
    q = torch.tensor(q_scale * rng.normal(size=(B, Sq, H, dh)), dtype=dtype,
                     device=dev)
    k = torch.tensor(rng.normal(size=(B, Skv, kv, dh)), dtype=dtype,
                     device=dev)
    v = torch.tensor(rng.normal(size=(B, Skv, kv, dh)), dtype=dtype,
                     device=dev)
    return q, k, v


def _want_kernel(dtype, dh):
    """The routing rule, written out: bf16 with dh 64/128 on the tensor
    cores, bf16 with dh 256 on the dh-256 tensor-core kernel, everything
    else (fp32 at dh 256 among it) on the CUDA cores."""
    from repro_torch.kernels import flash_attention as fa
    if dtype == torch.bfloat16 and dh in (64, 128):
        return fa.WGMMA
    if dtype == torch.bfloat16 and dh == 256:
        return fa.WGMMA_D256
    return fa.CUDA_CORE


@pytest.mark.parametrize("B,Sq,Skv,H,kv,dh,causal,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain(rng, hopper, B, Sq, Skv, H, kv, dh,
                                    causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(rng, B, Sq, Skv, H, kv, dh, dtype, hopper)
    before = fa.launches
    per_kernel = dict(fa.kernel_launches)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_kernel = _want_kernel(dtype, dh)
    assert {n: fa.kernel_launches[n] - c for n, c in per_kernel.items()} == {
        n: int(n == want_kernel) for n in fa.KERNELS}
    assert got.dtype == dtype and got.shape == (B, Sq, H, dh)
    want = fa.flash_attention_gqa_plain(q, k, v, causal=causal,
                                        window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dh,window", [(128, None), (64, 7), (256, None),
                                       (256, 7)])
def test_flash_wgmma_large_scores_rescale(rng, hopper, dh, window):
    """q scaled by 8: scores spread over a wide range, so the running max
    moves often and the online rescale carries the result."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(rng, 2, 512, 512, 8, 2, dh, torch.bfloat16,
                            hopper, q_scale=8.0)
    kernel = _want_kernel(torch.bfloat16, dh)
    before = fa.kernel_launches[kernel]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.kernel_launches[kernel] == before + 1
    want = fa.flash_attention_gqa_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dh", [128, 256])
def test_flash_wgmma_takes_strided_views(rng, hopper, dh):
    """q, k, v as views of (B, heads, S, dh) tensors, and v at an offset
    that is no multiple of 16 bytes: the wrapper copies what TMA cannot
    read, and the result is the same."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, kv = 2, 200, 4, 2
    bf = torch.bfloat16
    kernel = _want_kernel(bf, dh)
    q = torch.tensor(rng.normal(size=(B, H, S, dh)), dtype=bf,
                     device=hopper).transpose(1, 2)
    k = torch.tensor(rng.normal(size=(B, kv, S, dh)), dtype=bf,
                     device=hopper).transpose(1, 2)
    flat = torch.tensor(rng.normal(size=(B * S * kv * dh + 1,)), dtype=bf,
                        device=hopper)
    v = flat[1:].view(B, S, kv, dh)
    assert v.data_ptr() % 16 != 0
    before = fa.kernel_launches[kernel]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.kernel_launches[kernel] == before + 1
    want = fa.flash_attention_gqa_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_call_bhsd_layout(rng, hopper):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.tensor(rng.normal(size=(6, 96, 32)), dtype=torch.float32,
                            device=hopper) for _ in range(3))
    got = fa.flash_attention_kernel_call(q, k, v, causal=True, window=40)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=40)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dh", [64, 256])
def test_flash_wgmma_kernel_call_bhsd_layout(rng, hopper, dh):
    """The TPU kernel's (BH, S, dh) layout in bf16 reaches the tensor-core
    kernels as H = n_kv = 1."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.tensor(rng.normal(size=(6, 96, dh)),
                            dtype=torch.bfloat16, device=hopper)
               for _ in range(3))
    kernel = _want_kernel(torch.bfloat16, dh)
    before = fa.kernel_launches[kernel]
    got = fa.flash_attention_kernel_call(q, k, v, causal=True, window=40)
    assert fa.kernel_launches[kernel] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=40)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_rejects_what_it_cannot_take(hopper):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 2, 24), device=hopper)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_gqa(q, q, q)
    h = torch.zeros((1, 8, 2, 16), dtype=torch.float16, device=hopper)
    with pytest.raises(TypeError):
        fa.flash_attention_gqa(h, h, h)


SSD_CASES = [
    # B, S, H, P, N, chunk, with init_state
    (2, 48, 4, 8, 16, 16, False),
    (1, 64, 2, 16, 32, 32, True),
    (1, 32, 8, 8, 8, 8, False),
    (1, 512, 4, 64, 128, 256, True),      # mamba2-370m head and state
    (2, 300, 2, 64, 128, 100, False),     # chunk not a multiple of 64
]

#: bf16 x/B/C, as the model hands them over: (B, S, S padded, H, P, N,
#: chunk, with init_state).  The tensor-core kernel takes P = 64, N = 128
#: and chunks of 64..256 in steps of 64; the last case stays on the
#: CUDA-core kernel.
SSD_BF16_CASES = [
    (1, 512, 512, 4, 64, 128, 256, False),  # mamba2-370m head and state
    (1, 512, 512, 4, 64, 128, 256, True),
    (2, 256, 256, 4, 64, 128, 64, False),   # chunk 64
    (1, 512, 512, 2, 64, 128, 128, True),   # chunk 128
    (2, 300, 512, 2, 64, 128, 256, False),  # ragged S padded with dt = 0
    (2, 300, 300, 2, 64, 128, 100, False),  # chunk 100: CUDA-core kernel
]


def _ssd_inputs(rng, B, S, H, P, N, dev, init):
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (t(rng.normal(size=(B, S, H, P))),
            t(rng.uniform(0.01, 0.2, size=(B, S, H))),
            -t(rng.uniform(0.5, 2.0, size=(H,))),
            t(rng.normal(size=(B, S, 1, N))),
            t(rng.normal(size=(B, S, 1, N))),
            t(rng.normal(size=(B, H, P, N))) if init else None)


def _ssd_check(x, dt, A, Bm, Cm, s0, chunk, want_kernel):
    """One call of the ops wrapper on the card: exactly one launch, of
    ``want_kernel``, and y and the final state against the plain version
    on the same inputs at the reference's atol = rtol = 1e-4."""
    from repro_torch.kernels import ssd_scan as ss
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    before = ss.launches
    per_kernel = dict(ss.kernel_launches)
    y, state = ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=chunk,
                                  init_state=s0)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    assert {n: ss.kernel_launches[n] - c for n, c in per_kernel.items()} == {
        n: int(n == want_kernel) for n in ss.KERNELS}
    nc = S // chunk
    want_y, want_s = ss.ssd_scan_plain(
        x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), A,
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N), s0)
    assert y.dtype == state.dtype == torch.float32
    torch.testing.assert_close(y, want_y.reshape(B, S, H, P), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(state, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", SSD_CASES)
def test_ssd_kernel_matches_plain(rng, hopper, B, S, H, P, N, chunk, init):
    """fp32 inputs stay on the CUDA-core kernel (ssd_scan.cu)."""
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, B, S, H, P, N, hopper, init)
    _ssd_check(x, dt, A, Bm, Cm, s0, chunk, ss.CUDA_CORE)


@pytest.mark.parametrize("B,S,Sp,H,P,N,chunk,init", SSD_BF16_CASES)
def test_ssd_bf16_kernel_matches_plain(rng, hopper, B, S, Sp, H, P, N, chunk,
                                       init):
    """bf16 x/B/C on the tensor-core kernel (ssd_scan_wgmma.cu) where it
    takes the shape, held against the plain version on the same bf16
    inputs; a ragged S is padded to the chunk as ``ssm_block`` pads it,
    with dt = 0 on the padded steps."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, B, S, H, P, N, hopper, init)
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    if Sp > S:
        pad = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, Sp - S))
        x, dt, Bm, Cm = map(pad, (x, dt, Bm, Cm))
    _ssd_check(x, dt, A, Bm, Cm, s0, chunk, ss.kernel_for(x.dtype, P, N,
                                                           chunk))
    assert (ss.kernel_for(x.dtype, P, N, chunk) == ss.WGMMA) == (chunk != 100)


def test_ssd_kernel_rejects_a_state_too_large(hopper):
    from repro_torch.kernels import ssd_scan as ss
    x = torch.zeros((1, 1, 8, 1, 8), device=hopper)
    dt = torch.zeros((1, 1, 8, 1), device=hopper)
    big = torch.zeros((1, 1, 8, 256), device=hopper)
    with pytest.raises(ValueError, match="d_state"):
        ss.ssd_scan_kernel_call(x, dt, torch.zeros(1, device=hopper), big,
                                big)
    # float16, which neither kernel takes, raises too; nothing launched
    before = dict(ss.kernel_launches)
    h = torch.zeros((1, 1, 64, 1, 64), dtype=torch.float16, device=hopper)
    bc = torch.zeros((1, 1, 64, 128), dtype=torch.float16, device=hopper)
    with pytest.raises(TypeError):
        ss.ssd_scan_kernel_call(h, torch.zeros((1, 1, 64, 1), device=hopper),
                                torch.zeros(1, device=hopper), bc, bc)
    assert ss.kernel_launches == before


def test_ssd_wgmma_takes_strided_and_unaligned_inputs(rng, hopper):
    """x as a view of a (B, H, S, P) tensor and B at an offset that is no
    multiple of 16 bytes: the wrapper packs what TMA cannot read, and the
    result is the plain version's."""
    from repro_torch.kernels import ssd_scan as ss
    B, S, H, P, N, chunk = 2, 256, 4, 64, 128, 128
    bf = torch.bfloat16
    x = torch.tensor(rng.normal(size=(B, H, S, P)), dtype=bf,
                     device=hopper).transpose(1, 2)
    _, dt, A, _, Cm, _ = _ssd_inputs(rng, B, S, H, P, N, hopper, False)
    flat = torch.tensor(rng.normal(size=(B * S * N + 1,)), dtype=bf,
                        device=hopper)
    Bm = flat[1:].view(B, S, 1, N)
    assert Bm.data_ptr() % 16 != 0 and not x.is_contiguous()
    _ssd_check(x, dt, A, Bm, Cm.to(bf), None, chunk, ss.WGMMA)


@pytest.mark.parametrize("S", [20, 300])
def test_ssm_block_on_card_matches_host(rng, hopper, S):
    """The Mamba2 block through the kernel (with the sequence padded to a
    chunk multiple at S=300, chunk 256) agrees with the host's plain
    scan.  In fp32 the scan stays on the CUDA-core kernel."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm
    cfg = SSMConfig(d_state=128, head_dim=64, chunk_size=256)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_ssm_params(gen, 128, cfg, torch.float32, device="cpu")
    x = torch.tensor(rng.normal(size=(2, S, 128)), dtype=torch.float32)
    want, want_c = ssm.ssm_block(p, x, 128, cfg)
    pc = {n: t.to(hopper) for n, t in p.items()}
    before = ss.kernel_launches[ss.CUDA_CORE]
    got, got_c = ssm.ssm_block(pc, x.to(hopper), 128, cfg)
    assert ss.kernel_launches[ss.CUDA_CORE] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_c["state"].cpu(), want_c["state"],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [300, 1024])
def test_ssm_block_bf16_on_card_matches_host(rng, hopper, S):
    """The Mamba2 block in bf16 (the serving dtype), whose scan takes the
    tensor-core kernel on the card, against the host's plain block.  The
    block rounds the scan's fp32 output to bf16 before the gate, the norm
    and the output projection, and the card's bf16 GEMMs and convolution
    round at other places than the host's, so the two differ by a few bf16
    steps (2^-8 = 3.9e-3 relative each): a tolerance of 3e-2.  The final
    state is fp32 but is computed from those bf16 streams: 1e-2."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm
    cfg = SSMConfig(d_state=128, head_dim=64, chunk_size=256)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_ssm_params(gen, 128, cfg, torch.float32, device="cpu")
    x = torch.tensor(rng.normal(size=(2, S, 128)), dtype=torch.bfloat16)
    want, want_c = ssm.ssm_block(p, x, 128, cfg)
    pc = {n: t.to(hopper) for n, t in p.items()}
    before = ss.kernel_launches[ss.WGMMA]
    got, got_c = ssm.ssm_block(pc, x.to(hopper), 128, cfg)
    torch.cuda.synchronize()
    assert ss.kernel_launches[ss.WGMMA] == before + 1
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    torch.testing.assert_close(got_c["state"].cpu(), want_c["state"],
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("arch", [
    "llama3-8b", "mamba2-370m", "yi-6b", "glm4-9b", "starcoder2-7b",
    "recurrentgemma-9b", "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"])
def test_smoke_model_on_card_matches_host(rng, hopper, arch):
    """forward and prefill+decode of the smoke configs (fp32) on the card,
    through the kernels, against the host's plain versions.  Every
    attention layer (dense, moe, local_attn) launches flash attention once
    a forward, every ssm layer the SSD scan; the MoE configs run at a
    capacity that drops nothing, so decode equals forward."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as T
    cfg = moe.lossless_capacity(dataclasses.replace(
        registry.get_smoke_config(arch), compute_dtype="float32"))
    layers = [k for unit, reps in T.block_groups(cfg) for k in unit * reps]
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    want, _ = T.forward(params, toks, cfg)
    pc = convert.to_torch(params, hopper)
    counts = (fa.launches, ss.launches)
    got, _ = T.forward(pc, toks.to(hopper), cfg)
    launched = (fa.launches - counts[0], ss.launches - counts[1])
    assert launched == (sum(k != "ssm" and k != "rglru" for k in layers),
                        layers.count("ssm"))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    _, cache = T.prefill(pc, toks[:, :20].to(hopper), cfg, max_len=24)
    step, _ = T.decode_step(pc, toks[:, 20:].to(hopper), cache, 20, cfg)
    torch.testing.assert_close(step.cpu(), want[:, -1], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_encdec_vlm_smoke_on_card_matches_host(rng, hopper, arch):
    """The encoder-decoder and vlm smoke configs (fp32) on the card
    against the host: forward with the stub inputs (every encoder, self-
    and cross-attention layer launching flash attention once), and
    prefill + decode, the encoder K/V riding in the caches."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import convert
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              compute_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    kw = {}
    if cfg.is_encdec:
        kw["audio_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.num_image_tokens:
        kw["extra_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    want, _ = T.forward(params, toks, cfg, **kw)
    pc = convert.to_torch(params, hopper)
    kwc = {k: v.to(hopper) for k, v in kw.items()}
    before = fa.launches
    got, _ = T.forward(pc, toks.to(hopper), cfg, **kwc)
    assert fa.launches - before == (cfg.encoder_layers
                                    + cfg.num_layers * (2 if cfg.is_encdec
                                                        else 1))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    _, cache = T.prefill(pc, toks[:, :20].to(hopper), cfg, max_len=24,
                         **kwc)
    step, _ = T.decode_step(pc, toks[:, 20:].to(hopper), cache, 20, cfg)
    torch.testing.assert_close(step.cpu(), want[:, -1], atol=1e-4,
                               rtol=1e-4)


def _grads(fn, args, seed, draw_dtype=None):
    """Gradients of ``fn`` on ``args`` for a seeded random cotangent, drawn
    in the outputs' dtype or in ``draw_dtype`` (then cast to theirs: the
    same numbers for a float64 run of an fp32 function)."""
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=outs[0].device).manual_seed(seed)
    cot = [torch.randn(o.shape, generator=gen, device=o.device,
                       dtype=draw_dtype or o.dtype).to(o.dtype)
           for o in outs]
    return torch.autograd.grad(outs, args, cot)


@pytest.mark.parametrize("dtype,dh,causal,window", [
    (torch.bfloat16, 64, True, None), (torch.bfloat16, 64, False, None),
    (torch.bfloat16, 128, True, 7), (torch.bfloat16, 256, True, 100),
    (torch.float32, 32, True, None)])
def test_flash_gradients_on_card_equal_the_plain_paths(rng, hopper, dtype,
                                                       dh, causal, window):
    """Training through ``ops.flash_attention`` on the card: its forward
    launches the kernel once (and backward none), and its gradients are
    those of the plain path differentiated directly, on the same inputs
    (the same function, recomputed with grad enabled), within
    ``assert_close``'s default tolerance for the dtype."""
    from repro_torch.configs.base import AttentionConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention
    q, k, v = _flash_inputs(rng, 2, 200, 260, 4, 2, dh, dtype, hopper)
    before = fa.launches
    got = _grads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal, window=window), (q, k, v), 1)
    assert fa.launches == before + 1
    cfg = AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=dh,
                          causal=causal, window=window)
    pos = lambda n: torch.arange(n, device=hopper).expand(2, n)
    want = _grads(lambda q, k, v: attention(q, k, v, pos(200), pos(260),
                                            cfg), (q, k, v), 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        torch.testing.assert_close(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_gradients_on_card_equal_the_plain_paths(rng, hopper, dtype):
    """Training through ``ops.ssd_scan_fused`` on the card: one launch in
    forward, and the gradients of the plain chunked scan.  bf16 inputs
    take the backward kernel (one launch), held to its budget
    (``_assert_ssd_grads_close``: the bf16 gradients at ``assert_close``'s
    default, the fp32 ones within 1e-3 of their largest values); fp32
    ones recompute the plain scan, at ``assert_close``'s default."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssm import ssd_scan
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, 2, 512, 4, 64, 128, hopper,
                                       True)
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    args = (x, dt, A, Bm, Cm, s0)
    before, bwd = ss.launches, ss.backward_launches
    got = _grads(lambda *a: ops.ssd_scan_fused(*a[:5], chunk=256,
                                               init_state=a[5]), args, 2)
    assert ss.launches == before + 1
    assert ss.backward_launches == bwd + (dtype == torch.bfloat16)
    want = _grads(lambda *a: ssd_scan(*a[:5], 256, a[5]), args, 2)
    if dtype == torch.bfloat16:
        _assert_ssd_grads_close(got, want)
        return
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


def _bf16_miss(g, w):
    """How far the bf16 ``g`` misses ``assert_close``'s bf16 default
    against ``w`` (rounded to bf16, as ``assert_close`` takes it) beyond
    its relative part: the largest |g - w| - 1.6e-2 |w|, which the
    default holds to 1e-5."""
    w = w.to(g.dtype).double()
    return ((g.double() - w).abs() - 1.6e-2 * w.abs()).max().item()


def _assert_ssd_grads_close(got, want, plain=None):
    """The backward kernel's budget against the plain path's gradients
    ``want``: bf16 ones (x, B, C) at ``assert_close``'s bf16 default, fp32
    ones (dt, A, the initial state) within 1e-3 of the largest value of
    each, as ``test_ssd_gradients_stay_finite_where_the_decay_overflows``
    holds A's (sums over hundreds of nats of decay, in another order).
    With ``plain``, the plain path's fp32 gradients where ``want`` is its
    float64 ones: where that fp32 path needs more than the default's
    absolute 1e-5 against the same values (``_bf16_miss``), a bf16
    gradient of the kernel gets what it needs, and no more."""
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        if g.dtype == torch.bfloat16:
            atol = 1e-5
            if plain is not None:
                atol = max(atol, _bf16_miss(plain[k], w))
            torch.testing.assert_close(g, w.to(g.dtype), rtol=1.6e-2,
                                       atol=atol)
        else:
            w = w.to(g.dtype)
            scale = w.abs().max().item()
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * scale)


#: (B, S, H, chunk, with init_state, with a final-state cotangent): the
#: mamba2-370m train step's shape, and ragged ones
SSD_BACKWARD_CASES = [
    (4, 2048, 32, 256, False, False),    # the train cell's scans
    (1, 256, 4, 256, False, True),       # one chunk
    (2, 256, 4, 64, True, True),         # chunks of 64
    (1, 512, 2, 128, True, False),       # chunks of 128
    (2, 768, 3, 256, True, True),
]


@pytest.mark.parametrize("B,S,H,chunk,init,dstate", SSD_BACKWARD_CASES)
def test_ssd_backward_kernel_equals_the_plain_path(rng, hopper, B, S, H,
                                                   chunk, init, dstate):
    """bf16 x/B/C at P = 64, N = 128: the forward launches the tensor-core
    kernel and the backward the backward kernel, once each; its gradients
    against the plain chunked scan differentiated directly on the same
    inputs and seeded cotangents, taken in float64
    (``_assert_ssd_grads_close``): at the train step's shape the plain
    path's own fp32 gradients miss the bf16 default against float64 on a
    few elements of dB and dC near zero, where the kernel's do not."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssm import ssd_scan
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, B, S, H, 64, 128, hopper, init)
    x, Bm, Cm = (t.to(bf) for t in (x, Bm, Cm))
    args = (x, dt, A, Bm, Cm) + ((s0,) if init else ())
    pick = (lambda y, s: (y, s)) if dstate else (lambda y, s: y)
    fwd, bwd = ss.kernel_launches[ss.WGMMA], ss.backward_launches
    got = _grads(lambda *a: pick(*ops.ssd_scan_fused(
        *a[:5], chunk=chunk, init_state=a[5] if init else None)), args, 3)
    torch.cuda.synchronize()
    assert ss.kernel_launches[ss.WGMMA] == fwd + 1
    assert ss.backward_launches == bwd + 1
    want = _grads(lambda *a: pick(*ssd_scan(*a[:5], chunk,
                                            a[5] if init else None)),
                  [a.double() for a in args], 3, torch.float32)
    _assert_ssd_grads_close(got, want)


def test_ssd_backward_kernel_is_finite_where_the_decay_overflows(rng,
                                                                 hopper):
    """A chunk whose decays span thousands of nats (dt 0.5..2, A -8 and
    -16, as the host's ``test_ssd_gradients_stay_finite_where_the_decay_
    overflows``): the kernel masks before the exp, as the plain scan does,
    so its gradients stay finite, and they equal the plain path's taken in
    float64.  (In fp32 that path's dA sums the diagonal's terms by rows and
    by columns, which cancel, and misses the float64 value by 3 % of it at
    these widths; the kernel leaves them out.  Its dB misses the bf16
    default against float64 on an element near zero, as the kernel's
    does: the budget gives the kernel that fp32 path's miss and no more.)"""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssm import ssd_scan
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, 1, 512, 2, 64, 128, hopper,
                                       True)
    dt = torch.tensor(rng.uniform(0.5, 2.0, size=dt.shape),
                      dtype=torch.float32, device=hopper)
    A = torch.tensor([-8.0, -16.0], device=hopper)
    x, Bm, Cm = (t.to(bf) for t in (x, Bm, Cm))
    args = (x, dt, A, Bm, Cm, s0)
    bwd = ss.backward_launches
    got = _grads(lambda *a: ops.ssd_scan_fused(*a[:5], chunk=256,
                                               init_state=a[5]), args, 4)
    assert ss.backward_launches == bwd + 1
    want = _grads(lambda *a: ssd_scan(*a[:5], 256, a[5]),
                  [a.double() for a in args], 4, torch.float32)
    plain = _grads(lambda *a: ssd_scan(*a[:5], 256, a[5]), args, 4)
    _assert_ssd_grads_close(got, want, plain)


@pytest.mark.parametrize("B,S,H", [(2, 1024, 8), (4, 2048, 32)])
def test_ssd_backward_kernel_gives_the_same_bits_twice(rng, hopper, B, S,
                                                       H):
    """No floating-point atomics: two backward calls on the same inputs
    and cotangents give bit-identical gradients, also at the train step's
    shape, where three CTAs share an SM (a copy left in flight across a
    barrier changed the dx kernel's bits there, and only there)."""
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(rng, B, S, H, 64, 128, hopper,
                                       True)
    x, Bm, Cm = (t.to(bf) for t in (x, Bm, Cm))
    run = lambda: _grads(lambda *a: ops.ssd_scan_fused(
        *a[:5], chunk=256, init_state=a[5]), (x, dt, A, Bm, Cm, s0), 5)
    for g, h in zip(run(), run()):
        assert torch.equal(g, h)


def test_ssd_backward_kernel_only_where_the_forward_takes_wgmma(rng,
                                                                hopper):
    """fp32 inputs (the CUDA-core forward) keep the plain recompute: no
    backward launch; under no_grad the forward keeps no chunk states and
    a backward never runs."""
    from repro_torch.kernels import ssd_scan as ss
    x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, 1, 256, 2, 64, 128, hopper,
                                      False)
    bwd = ss.backward_launches
    got = _grads(lambda *a: ops.ssd_scan_fused(*a, chunk=256),
                 (x, dt, A, Bm, Cm), 6)
    assert ss.backward_launches == bwd
    assert all(torch.isfinite(g).all() for g in got)
    bf = torch.bfloat16
    with torch.no_grad():
        ops.ssd_scan_fused(x.to(bf), dt, A, Bm.to(bf), Cm.to(bf), chunk=256)
    assert ss.backward_launches == bwd


def test_check_faults_clear_after_a_d256_launch(rng, hopper):
    """A dh-256 launch that ran to its end leaves the give-up word clear;
    ``check_faults`` reads it (and returns) once per batch of launches."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_inputs(rng, 1, 300, 300, 16, 1, 256, torch.bfloat16,
                            hopper)
    before = fa.kernel_launches[fa.WGMMA_D256]
    ops.flash_attention(q, k, v, causal=True, window=100)
    assert fa.kernel_launches[fa.WGMMA_D256] == before + 1
    assert fa._unchecked
    fa.check_faults()
    assert not fa._unchecked
    fa.check_faults()



# -- the runtime's entry point and host backends next to the card -------------

def test_runctl_defaults_to_cuda_and_verifies(hopper, tmp_path, capsys):
    """``runctl`` with no ``--backend`` runs its workers on the card."""
    import json

    from repro_torch.launch import runctl
    out = tmp_path / "run.json"
    assert runctl.main(["--jobs", "3", "--K", "64", "--M", "8", "--N", "8",
                        "--straggler", "exp", "--json", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["backend"] == "cuda"
    assert summary["max_verify_rel_error"] < 1e-9
    assert summary["release_histogram"][-1] == 3
    assert "[runctl] 5 workers (cuda backend)" in capsys.readouterr().out


@pytest.mark.parametrize("shm", ["on", "off"])
def test_forked_process_workers_never_touch_cuda(hopper, shm):
    """A ``process`` run after CUDA is initialised in this process: the
    workers are forks of the transport's fork server, which never
    initialised CUDA, and a child that touched CUDA would raise and die.
    The run verifies, and every worker exits 0."""
    from repro_torch.runtime import (FusionNode, RoundContext,
                                     RuntimeConfig, make_transport,
                                     run_jobs)
    torch.zeros(1, device=hopper)
    assert torch.cuda.is_initialized()
    cfg = RuntimeConfig(backend="process", shm=shm, mu=(400.0, 650.0, 380.0),
                        straggler="exp", complexity=0.5, seed=1)
    res, _ = run_jobs(cfg, 3, K=64, M=8, N=8, verify=True)
    assert res.backend == "process" and res.workers_lost == 0
    assert np.nanmax(res.verify_errors) < 1e-9

    code = cfg.code()
    a = np.arange(16 * 4, dtype=np.float64).reshape(16, 4)
    X, Y = code.encode(a, a)
    fusion = FusionNode()
    transport = make_transport(cfg, sink=fusion.post)
    transport.start()
    try:
        ctx = RoundContext(0, 0)
        rf = fusion.begin_round(ctx, code.k)
        transport.submit_round(ctx, np.asarray(X), np.asarray(Y),
                               cfg.load_split())
        assert rf.wait(timeout=30.0)
        transport.purge_round(ctx)
        np.testing.assert_allclose(rf.decode(code), a.T @ a, rtol=1e-9)
    finally:
        transport.shutdown()
    assert [p.exitcode for p in transport.processes] == [0, 0, 0]


#: a smoke config of each decode path the server captures: attention
#: caches, the SSM state and conv windows, the RG-LRU state and the local
#: ring, top-k routing, and an encoder's K/V in the caches
GRAPH_ARCHS = ["llama3-8b", "mamba2-370m", "recurrentgemma-9b",
               "qwen2-moe-a2.7b", "whisper-tiny"]
_GB, _GS, _GG = 2, 16, 6       # batch, prompt (a multiple of the ring), gen


def _graph_case(arch, dev, **server_kw):
    """A card server of ``arch``'s smoke config (its own dtype), a seeded
    prompt and the prefill's caches."""
    from repro_torch.configs import registry
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import transformer as T
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device=dev)
    server = ProgressiveServer(cfg, params, device=dev, **server_kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (_GB, _GS), generator=gen,
                           device=dev)
    _, caches = server.prefill(prompt, _GS + _GG,
                               **T.stub_extras(cfg, _GB, dev, seed=2))
    return server, prompt, caches


def _copy(tree):
    from repro_torch.tree import tree_map
    return tree_map(torch.clone, tree)


def _restore(dst, src):
    """Put ``src``'s values into ``dst``'s storage (the server's own
    caches, which its captured step writes)."""
    from repro_torch.tree import leaves
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


@pytest.mark.parametrize("budget", [None, 1])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_decode_equals_eager_decode(hopper, arch, budget):
    """``ProgressiveServer.decode`` through its CUDA graphs gives the eager
    card decode's tokens, stats and caches (written back in place), and
    each replay's released logits are the eager step's on the same
    buffers: within 1e-2 of the largest logit (the same kernels in the
    same dtype: 0 expected, the largest difference printed)."""
    from repro_torch.tree import leaves
    server, prompt, caches = _graph_case(arch, hopper)
    assert server.graphs
    eager_caches, graph_caches = _copy(caches), _copy(caches)
    server.graphs = False
    want, want_stats = server.decode(prompt[:, -1:], eager_caches, _GS, _GG,
                                     layer_budget=budget)
    server.graphs = True
    got, stats = server.decode(prompt[:, -1:], graph_caches, _GS, _GG,
                               layer_budget=budget)
    assert torch.equal(got, want)
    assert stats == want_stats
    assert len(server.graph_log) == 1
    assert server.graph_log[0]["pool_bytes"] > 0
    for g, e in zip(leaves(graph_caches), leaves(eager_caches)):
        scale = max(e.float().abs().max().item(), 1.0)
        assert (g.float() - e.float()).abs().max().item() <= 1e-2 * scale

    # step by step: the replay's logits against the same step run eagerly
    release = server.m if budget is None else budget
    graph = server._graph(caches, _GB, release)
    assert len(server.graph_log) == 1          # the same shape: no capture
    _restore(graph.caches, caches)
    graph.start(prompt[:, -1:], _GS)
    tok, pos = prompt[:, -1:].clone(), torch.tensor(_GS, device=hopper)
    step_caches = _copy(caches)
    worst = 0.0
    with torch.no_grad():
        for _ in range(_GG):
            graph.replay()
            want_logits = server._step(tok, pos, step_caches, release)
            scale = want_logits.float().abs().max()
            diff = ((graph.out.float() - want_logits.float()).abs().max()
                    / scale).item()
            worst = max(worst, diff)
            assert diff <= 1e-2
            assert torch.equal(graph.tok, tok)
    print(f"{arch} budget {budget}: graph vs eager logits, largest "
          f"difference {worst} of the largest logit")
    server.close()


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_replay_makes_no_host_sync(hopper, arch):
    """Once captured, a whole graph decode of another request's caches of
    the same shape (new storage) captures nothing and runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no replay, cache or
    token copy, or bookkeeping step waits for the card."""
    server, prompt, caches = _graph_case(arch, hopper)
    first, _ = server.decode(prompt[:, -1:], _copy(caches), _GS, _GG)
    other = _copy(caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = server.decode(prompt[:, -1:], other, _GS, _GG)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(server.graph_log) == 1
    assert torch.equal(again, first)
    server.close()


def test_graph_decode_past_the_caches_raises(hopper):
    """A decode whose last position would not fit the attention caches
    raises on the host before any replay (a replay would hit
    ``index_copy_``'s device-side assert)."""
    server, prompt, caches = _graph_case("llama3-8b", hopper)
    with pytest.raises(ValueError, match="overrun caches"):
        server.decode(prompt[:, -1:], caches, _GS, _GG + 1)
    assert server.graph_log == []
    out, _ = server.decode(prompt[:, -1:], caches, _GS, _GG)
    assert out.shape == (_GB, _GG)
    server.close()


def test_graphs_on_a_cpu_server_raise(hopper):
    from repro_torch.configs import registry
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import transformer as T
    cfg = registry.get_smoke_config("llama3-8b")
    params = T.init_params(cfg, seed=0, device="cpu")
    assert not ProgressiveServer(cfg, params, device="cpu").graphs
    with pytest.raises(ValueError, match="graphs=True needs a card"):
        ProgressiveServer(cfg, params, device="cpu", graphs=True)


def test_a_capture_that_fails_raises(hopper, monkeypatch):
    """A step that reads the card on the host cannot be captured: the
    decode raises, captures nothing and does not fall back to eager."""
    from repro_torch.models import transformer as T
    server, prompt, caches = _graph_case("llama3-8b", hopper)
    real = T.hidden_step

    def syncing(params, token, caches, pos, cfg, **kw):
        int(pos.item())                       # a host read of the card
        return real(params, token, caches, pos, cfg, **kw)

    monkeypatch.setattr(T, "hidden_step", syncing)
    with pytest.raises(RuntimeError):
        server.decode(prompt[:, -1:], caches, _GS, _GG)
    assert server.graph_log == []
    monkeypatch.setattr(T, "hidden_step", real)
    torch.cuda.synchronize()
    server.close()


@pytest.fixture
def card_mesh(hopper):
    """The card's one-rank NCCL mesh, its process group destroyed after
    the test (last in this file: the forked-worker tests above run before
    any NCCL init)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    assert not dist.is_initialized()
    mesh = mesh_lib.make_test_mesh(1, 1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_card_mesh_layered_allreduce_and_distributed_matmul(rng, card_mesh):
    """On one NCCL rank: the layered all-reduce of a card gradient is the
    gradient within 2 * scale, and the distributed coded matmul's final
    resolution decodes to the exact integer product."""
    import torch.distributed as dist

    from repro_torch.core import coding
    from repro_torch.core.layered_matmul import distributed_layered_matmul
    from repro_torch.optim import layered_grads
    assert "nccl" in str(dist.get_backend())
    assert card_mesh.device_type == "cuda"
    g = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32)).cuda()
    out = layered_grads.layered_allreduce_tree({"g": g}, card_mesh, "data")
    scale = g.abs().max().item() / (2 ** 15 - 1)
    assert out["g"].is_cuda
    assert (out["g"] - g).abs().max().item() <= 2 * scale

    m, d = 2, 8
    a = rng.integers(-(2 ** 15), 2 ** 15, size=(256, 64))
    b = rng.integers(-(2 ** 15), 2 ** 15, size=(256, 32))
    results, layers = distributed_layered_matmul(
        card_mesh, "data", torch.from_numpy(a).cuda(),
        torch.from_numpy(b).cuda(), m=m, d=d, n1=2, n2=2, omega=1.5)
    assert results.is_cuda and tuple(results.shape) == (4, 6, 32, 16)
    code = coding.PolynomialCode(2, 2, 1.5)
    order = layering.all_minijobs_msb_first(m)
    res = results.cpu().numpy()
    final = sum(code.decode(list(range(4)), res[q][:4])
                * float(1 << ((i + j) * d)) for q, (_, i, j) in
                enumerate(order))
    np.testing.assert_array_equal(np.rint(final).astype(np.int64), a.T @ b)


@pytest.mark.parametrize("arch,kind,module", [
    ("llama3-8b", "prefill", "flash_attention"),
    ("mamba2-370m", "train", "ssd_scan")])
def test_card_cells_launch_the_kernels_and_equal_the_plain_steps(
        card_mesh, arch, kind, module):
    """The smoke config's prefill (flash attention) or train (SSD scan)
    cell on the card's one-rank mesh launches its kernel once per layer
    and gives the plain-tensor step's outputs bit for bit."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    mod = {"flash_attention": fa, "ssd_scan": ss}[module]
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              remat_policy="none")
    dev = torch.device("cuda", 0)
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=dev)
    batch = {"tokens": tokens}
    if kind == "train":
        batch["targets"] = torch.roll(tokens, -1, 1)
    # the eager step, which runs the wrappers once a call (the graphed
    # cells are held against it below)
    cell = steps.build_cell(cfg, ShapeConfig("c", 64, 2, kind), card_mesh,
                            TrainConfig())
    if kind == "train":
        step, optimizer = steps.make_train_step(cfg, TrainConfig())
        args = (params, optimizer.init(params), batch)
    else:
        step = steps.make_prefill_step(cfg, 64)
        args = (params, batch)
    before = mod.launches
    got = cell.eager(*args)
    torch.cuda.synchronize()
    assert mod.launches - before == cfg.num_layers
    want = step(*args)
    for g, w in zip(leaves(got), leaves(want)):
        if not isinstance(w, torch.Tensor):       # a count among metrics
            assert g == w
            continue
        if isinstance(g, DTensor):
            assert g.device_mesh == card_mesh
            g = g.full_tensor()
        assert g.is_cuda and torch.equal(g, w)


# ---------------------------------------------------------------------------
# The compiled cells and train step: CUDA graphs against eager
# ---------------------------------------------------------------------------

def _full_tree(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map
    return tree_map(lambda x: (x.full_tensor() if isinstance(x, DTensor)
                               else x.clone() if isinstance(x, torch.Tensor)
                               else x), tree)


def _bit_equal(got, want):
    from repro_torch.tree import leaves
    g, w = leaves(_full_tree(got)), leaves(_full_tree(want))
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), i
        else:
            assert a == b, i


@pytest.mark.parametrize("arch", ["mamba2-370m", "internvl2-1b"])
def test_graph_train_loop_equals_eager(hopper, arch):
    """``train_loop`` replaying its step from a CUDA graph (forward,
    backward, AdamW and the write-back of parameters and state captured
    once) against the same 3 steps eagerly: losses, gradient norms and
    parameters bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    cfg = registry.get_smoke_config(arch)
    kw = dict(batch=2, seq=64, steps=3, log_every=1, device=hopper)
    eager = train.train_loop(cfg, TrainConfig(), graphs=False, **kw)
    graph = train.train_loop(cfg, TrainConfig(), **kw)
    assert eager["graph"] is None and graph["graph"].captures == 1
    assert graph["losses"] == eager["losses"]
    assert graph["grad_norms"] == eager["grad_norms"]
    _bit_equal((graph["params"], graph["opt_state"]),
               (eager["params"], eager["opt_state"]))


def test_graph_cells_equal_eager(card_mesh):
    """llama3-8b's smoke prefill and decode cells and mamba2-370m's train
    cell on the card's one-rank mesh, from CUDA graphs against the same
    cells run eagerly, bit for bit: one capture per cell for two prefills,
    four decode steps and two train steps; a later prefill leaves what an
    earlier one returned as it was; decode writes the caller's caches."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    dev = torch.device("cuda", 0)
    cfg = registry.get_smoke_config("llama3-8b")
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 37), generator=gen,
                           device=dev)
    cells = {kind: steps.build_cell(cfg, ShapeConfig("c", 40, 2, kind),
                                    card_mesh)
             for kind in ("prefill", "decode")}
    placed = steps.laid_out(params, card_mesh,
                            cells["prefill"].in_shardings[0])
    outs = {}
    for graphs in (False, True):
        prefill, decode = (cells[k].fn if graphs else cells[k].eager
                           for k in ("prefill", "decode"))
        first = prefill(placed, {"tokens": tokens[0, :, :36]})
        kept = _full_tree(first)
        prefill(placed, {"tokens": tokens[1, :, :36]})
        _bit_equal(first, kept)         # the later call left it alone
        caches, token, steps_out = first[1], tokens[0, :, 36:], []
        for i in range(4):
            # the eager step at the position tensor the graph reads
            pos = 36 + i if graphs else torch.tensor(36 + i, device=dev)
            logits, nxt, got_caches = decode(placed, {
                "token": token, "pos": pos, "caches": caches})
            assert all(a is b for a, b in zip(leaves(got_caches),
                                              leaves(caches)))
            steps_out.append(_full_tree((logits, nxt)))
            token = nxt.full_tensor()[:, None]
        outs[graphs] = (kept, steps_out, _full_tree(caches))
    _bit_equal(outs[True], outs[False])
    assert [cells[k].graph.captures for k in ("prefill", "decode")] \
        == [1, 1]

    cfg = registry.get_smoke_config("mamba2-370m")
    params = T.init_params(cfg, seed=0, device=dev)
    step, optimizer = steps.make_train_step(cfg, TrainConfig())
    batch = {"tokens": tokens[0, :, :32], "targets": tokens[0, :, 1:33]}
    cell = steps.build_cell(cfg, ShapeConfig("t", 32, 2, "train"),
                            card_mesh, TrainConfig())
    runs = {}
    for graphs in (False, True):
        p, o = steps.laid_out((params, optimizer.init(params)), card_mesh,
                              cell.in_shardings[:2])
        metrics = []
        for _ in range(2):
            p, o, m = (cell.fn if graphs else cell.eager)(p, o, batch)
            metrics.append(_full_tree(m))
        runs[graphs] = (metrics, _full_tree((p, o)))
    assert cell.graph.captures == 1
    _bit_equal(runs[True], runs[False])


def test_graph_cell_on_plain_parameters_holds_one_capture(card_mesh):
    """A graphed prefill cell called with new plain parameters each call
    (copies, so new storage whatever placing them does; the graph reads
    them in place) captures each call; the new capture replaces the old,
    so what the cell holds stays one graph and the card's memory does not
    grow from the second call to the fourth."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    dev = torch.device("cuda", 0)
    cfg = registry.get_smoke_config("llama3-8b")
    params = T.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 36), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    cell = steps.build_cell(cfg, ShapeConfig("c", 40, 2, "prefill"),
                            card_mesh)
    want = _full_tree(cell.eager(params, {"tokens": tokens}))
    held = []
    for _ in range(4):
        _bit_equal(cell.fn(tree_map(torch.clone, params),
                           {"tokens": tokens}), want)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held.append((len(cell.graph.graphs),
                     torch.cuda.memory_allocated(dev),
                     torch.cuda.memory_reserved(dev)))
    assert cell.graph.captures == 4
    assert [n for n, _, _ in held] == [1, 1, 1, 1]
    for n, allocated, reserved in held[2:]:
        assert allocated <= held[1][1] and reserved <= held[1][2], held
