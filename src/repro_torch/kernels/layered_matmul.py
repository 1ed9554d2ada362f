"""Layered-resolution int8 digit-plane matmul: CUDA kernel + plain version.

Port of the TPU kernel ``layered_matmul_kernel_call``
(``src/repro/kernels/layered_matmul.py:71``): the paper's ``m**2``
mini-job grid as one pass.  For int8 digit planes ``A_i``, ``B_j`` it
returns the ``L = 2m - 1`` exact, unscaled, non-cumulative int32 partials

    out[l] = sum_{i + j = 2m-2-l} A_i^T B_j

and leaves the ``2**((i+j) d)`` scales and the cumulative sum to the
fusion (``ops.layered_matmul``).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/layered_matmul.cu`` (int8 ``mma.sync``, one CTA per 64x64 output
tile for all L layers, the K loop inside the block; see the source for
what bounds it and what the design does about that).  It needs
K-contiguous planes, ``(m, M, K)`` and ``(m, N, K)``, with K a multiple
of :data:`K_ALIGN`, so :func:`layered_matmul_kmajor` takes that layout
(padding K with zeros where a caller's planes lack it) and
:func:`layered_matmul_kernel_call` keeps the reference's ``(m, K, M)`` /
``(m, K, N)`` layout by transposing first.  On a CPU tensor the wrapper
runs :func:`layered_matmul_plain`.  There is no fallback between the two:
a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layering
from repro_torch.kernels import _build

__all__ = ["K_ALIGN", "layered_matmul_kernel_call", "layered_matmul_kmajor",
           "layered_matmul_plain", "launches"]

#: The kernel reads K in 16-byte vectors: the contraction length of the
#: planes it is given and their start addresses are multiples of this.
K_ALIGN = 16

#: Kernel launches so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_SOURCE = "layered_matmul"
_bound = None


def layered_matmul_plain(a_km: torch.Tensor, b_km: torch.Tensor, *,
                         m: int) -> torch.Tensor:
    """Plain PyTorch version on K-major planes ``(m, M, K)``, ``(m, N, K)``.

    Each plane product is a float64 matmul cast to int32: exact while
    ``J(l) * K * (2**d - 1)**2 < 2**53``, which covers the kernel's whole
    int32-exact range.  (PyTorch has no int32 CUDA matmul.)
    """
    _, M, _ = a_km.shape
    N = b_km.shape[1]
    a64 = a_km.to(torch.float64)
    b64 = b_km.to(torch.float64)
    out = torch.empty((2 * m - 1, M, N), dtype=torch.int32,
                      device=a_km.device)
    for l in range(2 * m - 1):
        part = torch.zeros((M, N), dtype=torch.float64, device=a_km.device)
        for (i, j) in layering.layer_minijobs(m, l):
            part += a64[i] @ b64[j].T
        out[l] = part.to(torch.int32)
    return out


def _entry():
    """The kernel's C entry, bound once: ``(fn, max_planes)``."""
    global _bound
    if _bound is None:
        lib = _build.load(_SOURCE)
        fn = lib.layered_matmul_s8
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        max_planes = lib.layered_matmul_max_planes
        max_planes.argtypes = []
        max_planes.restype = ctypes.c_int
        _bound = (fn, max_planes())
    return _bound


def _kernel_operand(planes: torch.Tensor) -> torch.Tensor:
    """``planes`` as the kernel reads them: contiguous, 16-byte aligned,
    with K padded by zeros to a multiple of :data:`K_ALIGN`.  Planes from
    ``ops`` already are; other planes are copied."""
    R, K = planes.shape[1:]
    pad = -K % K_ALIGN
    if (not pad and planes.is_contiguous()
            and planes.data_ptr() % K_ALIGN == 0):
        return planes
    out = torch.zeros((planes.shape[0], R, K + pad), dtype=torch.int8,
                      device=planes.device)
    out[:, :, :K] = planes
    return out


def _launch(a_km: torch.Tensor, b_km: torch.Tensor, m: int) -> torch.Tensor:
    global launches
    dev = a_km.device
    if b_km.device != dev:
        raise ValueError(f"planes on different devices: {dev} vs "
                         f"{b_km.device}")
    _build.require_hopper(dev, _SOURCE)
    fn, max_planes = _entry()
    if m > max_planes:
        raise ValueError(f"kernel supports m <= {max_planes}, got m={m}")
    a_km = _kernel_operand(a_km)
    b_km = _kernel_operand(b_km)
    _, M, K = a_km.shape
    N = b_km.shape[1]
    out = torch.empty((2 * m - 1, M, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_km.data_ptr(), b_km.data_ptr(), out.data_ptr(), m, M, N, K,
                 stream)
    if err != 0:
        raise RuntimeError(f"layered_matmul kernel launch failed: CUDA error "
                           f"{err} (m={m} M={M} N={N} K={K})")
    launches += 1
    return out


def layered_matmul_kmajor(a_km: torch.Tensor, b_km: torch.Tensor, *,
                          m: int) -> torch.Tensor:
    """Per-layer int32 partials from K-major int8 planes.

    a_km: (m, M, K) int8   b_km: (m, N, K) int8   ->   (L, M, N) int32.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    if a_km.ndim != 3 or b_km.ndim != 3:
        raise ValueError(f"planes must be 3-D, got {tuple(a_km.shape)} and "
                         f"{tuple(b_km.shape)}")
    if a_km.shape[0] != m or b_km.shape[0] != m:
        raise ValueError(f"plane count mismatch: {tuple(a_km.shape)} / "
                         f"{tuple(b_km.shape)} vs m={m}")
    if a_km.shape[2] != b_km.shape[2]:
        raise ValueError(f"contraction dims differ: {tuple(a_km.shape)} vs "
                         f"{tuple(b_km.shape)}")
    if a_km.dtype != torch.int8 or b_km.dtype != torch.int8:
        raise TypeError(f"planes must be int8, got {a_km.dtype} / "
                        f"{b_km.dtype}")
    if a_km.device.type == "cuda":
        return _launch(a_km, b_km, m)
    if a_km.device.type == "cpu" and b_km.device.type == "cpu":
        return layered_matmul_plain(a_km, b_km, m=m)
    raise ValueError(f"unsupported devices {a_km.device} / {b_km.device}")


def layered_matmul_kernel_call(a_planes: torch.Tensor,
                               b_planes: torch.Tensor, *, m: int,
                               d: int) -> torch.Tensor:
    """Exact per-layer partial sums of ``A^T B`` from int8 digit planes.

    a_planes: (m, K, M) int8   b_planes: (m, K, N) int8 (the reference's
    layout).  Returns (L, M, N) int32; row ``l`` holds the UNSCALED layer-l
    partial ``sum_{i+j = 2m-2-l} A_i^T B_j`` — the fusion step
    (``ops.layered_matmul``) applies ``2**((i+j) d)`` and the cumulative
    sum.  ``d`` is the digit width the planes were cut with (the partials
    do not depend on it).
    """
    del d
    mm = a_planes.shape[0]
    if mm != m or b_planes.shape[0] != m:
        raise ValueError(f"plane count mismatch: {tuple(a_planes.shape)} vs "
                         f"m={m}")
    return layered_matmul_kmajor(a_planes.transpose(1, 2),
                                 b_planes.transpose(1, 2), m=m)
