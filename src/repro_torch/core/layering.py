"""Layered resolution via digit decomposition (paper §III, Definition 1).

Fixed-point operands are decomposed in base ``2**d`` into ``m`` digit-plane
chunks.  For matrices ``A = sum_i A_i 2**(i d)`` and ``B = sum_j B_j 2**(j d)``

    A^T B = sum_{i,j} A_i^T B_j 2**((i+j) d)

and grouping the ``m**2`` *mini-jobs* ``(i, j)`` by anti-diagonal
``s = i + j`` (MSB-first, i.e. largest ``s`` first) yields ``L = 2m - 1``
resolution layers.  The ``l``-th resolution (Definition 1) is the partial sum
over ``(2m-2) - l <= i + j <= 2m-2``.  Upgrading resolution ``l-1 -> l`` costs
``J(l) = min(l+1, 2m-1-l)`` extra mini-jobs and ``sum_l J(l) = m**2``:
layering adds zero total compute.

Signed integers are supported exactly: the *top* chunk is an arithmetic
right-shift (so it carries the sign) while lower chunks are unsigned
``d``-bit digits.  Reconstruction is exact for any int32/int64 input that
fits in ``m * d`` bits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "num_layers",
    "layer_minijobs",
    "minijobs_per_layer",
    "cumulative_minijobs",
    "all_minijobs_msb_first",
    "decompose",
    "digit",
    "reconstruct",
    "quantize",
    "dequantize",
    "layered_matmul_reference",
    "layered_matmul_torch",
    "resolution_error_bound",
]


# ---------------------------------------------------------------------------
# Layer bookkeeping (Definition 1)
# ---------------------------------------------------------------------------

def num_layers(m: int) -> int:
    """L = 2m - 1 resolution layers for an m-chunk decomposition."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    return 2 * m - 1


def layer_minijobs(m: int, l: int) -> list[tuple[int, int]]:
    """Mini-jobs (i, j) that layer ``l`` adds: ``i + j = (2m-2) - l``.

    Layer 0 is the single MSB*MSB product (i = j = m-1); the final layer
    ``L-1`` is the LSB*LSB product (i = j = 0).
    """
    L = num_layers(m)
    if not 0 <= l < L:
        raise ValueError(f"layer {l} out of range for m={m} (L={L})")
    s = (2 * m - 2) - l
    return [(i, s - i) for i in range(m) if 0 <= s - i < m]


def minijobs_per_layer(m: int) -> list[int]:
    """J(l) = min(l+1, 2m-1-l); J over all layers sums to m**2."""
    return [min(l + 1, 2 * m - 1 - l) for l in range(num_layers(m))]


def cumulative_minijobs(m: int) -> list[int]:
    """Number of mini-jobs needed for resolution l: sum_{i<=l} J(i)."""
    out, tot = [], 0
    for j in minijobs_per_layer(m):
        tot += j
        out.append(tot)
    return out


def all_minijobs_msb_first(m: int) -> list[tuple[int, int, int]]:
    """All (layer, i, j) triples in execution order (MSB-first)."""
    out = []
    for l in range(num_layers(m)):
        for (i, j) in layer_minijobs(m, l):
            out.append((l, i, j))
    return out


# ---------------------------------------------------------------------------
# Digit decomposition / reconstruction
# ---------------------------------------------------------------------------

def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def decompose(x: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """Decompose integer tensor into m digit-plane chunks, base 2**d.

    Returns a tensor of shape ``(m,) + x.shape`` on ``x``'s device;
    ``chunks[i]`` holds digit ``i`` (LSB at i=0).  Chunks ``0..m-2`` are
    unsigned d-bit digits; chunk ``m-1`` is the arithmetic-shift remainder
    and carries the sign, so

        x == sum_i chunks[i] * 2**(i*d)            (exactly)

    for any signed x representable in the accumulator dtype.
    """
    if m < 1 or d < 1:
        raise ValueError(f"need m >= 1 and d >= 1, got m={m} d={d}")
    if not _is_integer(x.dtype):
        raise TypeError(f"decompose expects an integer tensor, got {x.dtype}")
    x = x.to(torch.int32) if x.element_size() <= 4 else x
    return torch.stack([digit(x, i, m, d) for i in range(m)], dim=0)


def digit(x: torch.Tensor, i: int, m: int, d: int) -> torch.Tensor:
    """Chunk ``i`` of :func:`decompose` for a signed integer tensor ``x``,
    in ``x``'s dtype and memory layout."""
    # arithmetic shift on signed ints
    shifted = torch.bitwise_right_shift(x, i * d) if i else x
    if i == m - 1:
        return shifted  # top chunk keeps sign + any overflow bits
    return torch.bitwise_and(shifted, (1 << d) - 1)


def reconstruct(chunks: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`decompose`: ``sum_i chunks[i] * 2**(i*d)``.

    The sum stays in the chunks' dtype (``torch.sum`` would widen int32
    to int64), so it wraps exactly as the reference does.
    """
    m = chunks.shape[0]
    weights = torch.tensor([1 << (i * d) for i in range(m)],
                           dtype=chunks.dtype, device=chunks.device
                           ).reshape((m,) + (1,) * (chunks.ndim - 1))
    return torch.sum(chunks * weights, dim=0, dtype=chunks.dtype)


# ---------------------------------------------------------------------------
# Fixed-point quantization (float <-> int) so real matrices can be layered
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, total_bits: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization of a float tensor to signed ints.

    Returns ``(q, scale)`` with ``x ~= q * scale`` and
    ``q in [-(2**(b-1)-1), 2**(b-1)-1]``.  The arithmetic runs in ``x``'s
    dtype on ``x``'s device; ``scale`` is float32.
    """
    absmax = torch.clamp(torch.max(torch.abs(x)), min=1e-30)
    qmax = float(2 ** (total_bits - 1) - 1)
    scale = absmax / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    dtype = torch.int32 if total_bits <= 31 else torch.int64
    return q.to(dtype), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Reference layered matmul (the oracle every other implementation matches)
# ---------------------------------------------------------------------------

def _np_decompose(x: np.ndarray, m: int, d: int) -> np.ndarray:
    """NumPy twin of :func:`decompose` (int64 host arithmetic, always exact)."""
    x = np.asarray(x, dtype=np.int64)
    mask = (1 << d) - 1
    chunks = []
    for i in range(m):
        shifted = x >> (i * d)
        chunks.append(shifted if i == m - 1 else shifted & mask)
    return np.stack(chunks, axis=0)


def _np_plane_product(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``x.T @ y`` of two int64 digit planes, exactly.

    Through float64 BLAS when every partial sum fits float64's 53-bit
    significand (``max|x| * max|y| * K < 2**53``: then every sum of a
    subset of the products is an integer below that bound, whatever order
    BLAS adds them in), else through NumPy's int64 matmul, which has no
    BLAS and is orders of magnitude slower at the runtime's sizes.  The
    result is the same int64 matrix either way.
    """
    bound = (int(np.abs(x).max(initial=0)) * int(np.abs(y).max(initial=0))
             * x.shape[0])
    if bound < 2 ** 53:
        return (x.T.astype(np.float64) @ y.astype(np.float64)).astype(
            np.int64)
    return x.T @ y


def layered_matmul_reference(a, b, *, m: int, d: int) -> np.ndarray:
    """Exact layered computation of ``a.T @ b`` for integer a (K, M), b (K, N).

    Returns ``resolutions`` of shape (L, M, N): ``resolutions[l]`` is the
    l-th resolution per Definition 1 (cumulative over anti-diagonals
    ``s >= 2m-2-l``, scaled by ``2**(s d)``).  ``resolutions[-1] == a.T @ b``
    exactly.

    Host-side NumPy (int64) so exactness never depends on the device;
    this is the oracle that the CUDA kernel and the torch device path are
    tested against.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    ca = _np_decompose(a, m, d)  # (m, K, M)
    cb = _np_decompose(b, m, d)  # (m, K, N)
    L = num_layers(m)
    partials = []
    for l in range(L):
        acc = np.zeros((a.shape[1], b.shape[1]), dtype=np.int64)
        for (i, j) in layer_minijobs(m, l):
            prod = _np_plane_product(ca[i], cb[j])
            acc = acc + prod * (1 << ((i + j) * d))
        partials.append(acc)
    return np.cumsum(np.stack(partials, axis=0), axis=0)


def layered_matmul_torch(a: torch.Tensor, b: torch.Tensor, *, m: int,
                         d: int) -> torch.Tensor:
    """Device-side layered matmul returning float32 resolutions (L, M, N).

    Runs on ``a``'s device.  Per-plane products are float64 matmuls cast
    to int32 through int64 (PyTorch has no int32 CUDA matmul): exact while
    ``K * (2**d - 1)**2 < 2**31``, the int32 range the reference
    accumulates in, and past it wrapped as the reference's are.  The cross-plane combination ``* 2**((i+j)d)`` is
    float32, exact for results < 2**24 per plane-scale.
    """
    ca = decompose(a.to(torch.int32), m, d).to(torch.float64)
    cb = decompose(b.to(torch.int32), m, d).to(torch.float64)
    L = num_layers(m)
    partials = []
    for l in range(L):
        acc = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32,
                          device=a.device)
        for (i, j) in layer_minijobs(m, l):
            prod = (ca[i].T @ cb[j]).to(torch.int64).to(torch.int32)
            acc = acc + prod.to(torch.float32) * float(1 << ((i + j) * d))
        partials.append(acc)
    return torch.cumsum(torch.stack(partials, dim=0), dim=0)


def resolution_error_bound(m: int, d: int, K: int, l: int) -> int:
    """Worst-case |A^T B - (A^T B)|_l| for unsigned d-bit digits.

    The missing mini-jobs are all (i, j) with i+j < (2m-2)-l; each missing
    term is bounded by K * (2**d - 1)**2 * 2**((i+j) d).
    """
    bound = 0
    for s in range(0, (2 * m - 2) - l):
        count = min(s + 1, 2 * m - 1 - s)
        bound += count * K * (2**d - 1) ** 2 * (1 << (s * d))
    return bound
