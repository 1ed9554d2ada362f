"""The port's CUDA kernel against its plain version, on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip.
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


@pytest.mark.parametrize("m,d,K,M,N", [
    (2, 7, 1024, 128, 128), (3, 5, 1000, 200, 328), (4, 4, 33, 7, 9),
    (1, 7, 16, 8, 8), (2, 7, 4096, 64, 1000)])
def test_kernel_bit_equal_to_plain(rng, hopper, m, d, K, M, N):
    a, pa = _planes(rng, m, d, K, M, hopper)
    b, pb = _planes(rng, m, d, K, N, hopper)
    before = lm.launches
    got = lm.layered_matmul_kmajor(pa, pb, m=m)
    torch.cuda.synchronize()
    assert lm.launches == before + 1
    want = lm.layered_matmul_plain(pa, pb, m=m)
    assert torch.equal(got, want)
    scales = np.asarray([1 << ((2 * m - 2 - l) * d)
                         for l in range(2 * m - 1)], np.int64)
    full = (got.cpu().numpy().astype(np.int64)
            * scales[:, None, None]).sum(0)
    np.testing.assert_array_equal(
        full, a.numpy().astype(np.int64).T @ b.numpy().astype(np.int64))


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
    got = lm.layered_matmul_kmajor(shifted, pb, m=m)
    assert lm.launches == before + 1
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


def test_too_many_planes_raise(hopper):
    z = torch.zeros((5, 8, 16), dtype=torch.int8, device=hopper)
    with pytest.raises(ValueError, match="m <= 4"):
        lm.layered_matmul_kmajor(z, z, m=5)
