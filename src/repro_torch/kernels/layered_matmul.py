"""Layered-resolution int8 digit-plane matmul: three CUDA kernels + plain
version.

Port of the TPU kernel ``layered_matmul_kernel_call``
(``src/repro/kernels/layered_matmul.py:71``): the paper's ``m**2``
mini-job grid as one pass.  For int8 digit planes ``A_i``, ``B_j`` it
returns the ``L = 2m - 1`` exact, unscaled, non-cumulative int32 partials

    out[l] = sum_{i + j = 2m-2-l} A_i^T B_j

and leaves the ``2**((i+j) d)`` scales and the cumulative sum to the
fusion (``ops.layered_matmul``).

On a CUDA tensor the wrapper launches one of three hand-written Hopper
kernels, chosen by :func:`kernel_for` from ``(m, M, N, K)``:

- ``layered_matmul_wgmma`` (``csrc/layered_matmul_wgmma.cu``): m <= 3,
  the LM head's m = 2 among them.  int8 ``wgmma`` fed by TMA through a
  multistage ring, tiles wide in N (64 x 256 for M <= 64, else 128 x 128;
  half as wide at m = 3).
- ``layered_matmul`` (``csrc/layered_matmul.cu``): m = 4, whose seven
  layers of accumulators do not fit the wgmma tile's registers.  int8
  ``mma.sync``, one CTA per 64x64 output tile.
- ``layered_matmul_grouped`` (``csrc/layered_matmul_grouped.cu``): m >= 5,
  whose ``2m - 1`` layers of accumulators fit no tile's registers.  int8
  ``mma.sync``, one CTA per 64x64 output tile and group of at most seven
  layers (the groups on ``grid.z``), each running only its layers' plane
  pairs.  The Pallas kernel takes any m, and so does this one.

All three need K-contiguous planes, ``(m, M, K)`` and ``(m, N, K)``, with K a
multiple of :data:`K_ALIGN`, so :func:`layered_matmul_kmajor` takes that
layout (padding K with zeros where a caller's planes lack it) and
:func:`layered_matmul_kernel_call` keeps the reference's ``(m, K, M)`` /
``(m, K, N)`` layout by transposing first.  On a CPU tensor the wrapper
runs :func:`layered_matmul_plain`.  There is no fallback: a CUDA tensor
that no kernel takes raises, and so does a failed launch.
:data:`launches` counts every call that launches a kernel;
:data:`kernel_launches` counts them per kernel source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import layering
from repro_torch.kernels import _build

__all__ = ["K_ALIGN", "KERNELS", "kernel_for",
           "kernel_launches", "layered_matmul_kernel_call",
           "layered_matmul_kmajor", "layered_matmul_plain", "launches"]

#: The kernels read K in 16-byte rows (TMA's stride unit, the mma.sync
#: kernel's vector): the contraction length of the planes they are given
#: and their start addresses are multiples of this.
K_ALIGN = 16

#: The three kernels, by source name (``csrc/<name>.cu``).
WGMMA = "layered_matmul_wgmma"
MMA_SYNC = "layered_matmul"
GROUPED = "layered_matmul_grouped"
KERNELS = (WGMMA, MMA_SYNC, GROUPED)

#: Most planes the two register-resident kernels are built for; more go
#: to :data:`GROUPED`, which takes any number.
WGMMA_MAX_PLANES = 3
MMA_SYNC_MAX_PLANES = 4

#: Kernel launches so far, of all three kernels (incremented only where a CUDA
#: kernel is launched; a caller resets it to 0 to count one run).
launches = 0
#: The same count per kernel; a caller resets each entry to 0 with it.
kernel_launches = dict.fromkeys(KERNELS, 0)

_bound: dict = {}


def layered_matmul_plain(a_km: torch.Tensor, b_km: torch.Tensor, *,
                         m: int) -> torch.Tensor:
    """Plain PyTorch version on K-major planes ``(m, M, K)``, ``(m, N, K)``.

    Each plane product is a float64 matmul, exact while
    ``J(l) * K * (2**d - 1)**2 < 2**53``, which covers the kernel's whole
    int32-exact range.  (PyTorch has no int32 CUDA matmul.)  It goes to
    int32 through int64, so a partial past 2**31 wraps as the reference's
    int32 accumulation and the kernels' do, where a straight cast would
    saturate.
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
        out[l] = part.to(torch.int64).to(torch.int32)
    return out


def kernel_for(m: int, M: int, N: int, K: int) -> str:
    """The kernel that takes ``m`` planes of an ``(M, K) x (N, K)`` product
    on the card.

    m <= 3 -> :data:`WGMMA` (its L layers of 64-wide int32 accumulators
    fit a warpgroup's registers); m = 4 -> :data:`MMA_SYNC`; m >= 5 ->
    :data:`GROUPED` (at most seven layers a CTA).  Raises ``ValueError``
    for m < 1 and for an empty shape.
    """
    if m < 1:
        raise ValueError(f"kernel needs m >= 1 planes, got m={m}")
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"empty product: M={M} N={N} K={K}")
    if m <= WGMMA_MAX_PLANES:
        return WGMMA
    return MMA_SYNC if m <= MMA_SYNC_MAX_PLANES else GROUPED


def _entry(name: str):
    """The C entry of kernel ``name``, bound once."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_s8")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _kernel_operand(planes: torch.Tensor) -> torch.Tensor:
    """``planes`` as the kernel reads them: contiguous, 16-byte aligned,
    with K padded by zeros to a multiple of :data:`K_ALIGN`.  Planes from
    ``ops`` already are; other planes are copied.  All three kernels take
    this: TMA zero-fills the rest of the wgmma kernel's 128-byte K
    slices."""
    R, K = planes.shape[1:]
    pad = -K % K_ALIGN
    if (not pad and planes.is_contiguous()
            and planes.data_ptr() % K_ALIGN == 0):
        return planes
    out = torch.zeros((planes.shape[0], R, K + pad), dtype=torch.int8,
                      device=planes.device)
    out[:, :, :K] = planes
    return out


def _launch(a_km: torch.Tensor, b_km: torch.Tensor, m: int,
            kernel: Optional[str] = None) -> torch.Tensor:
    """K-major planes on the card, through ``kernel`` (default:
    :func:`kernel_for`'s choice)."""
    global launches
    dev = a_km.device
    if b_km.device != dev:
        raise ValueError(f"planes on different devices: {dev} vs "
                         f"{b_km.device}")
    _, M, K = a_km.shape
    N = b_km.shape[1]
    chosen = kernel_for(m, M, N, K)
    kernel = kernel or chosen
    if kernel == WGMMA and m > WGMMA_MAX_PLANES:
        raise ValueError(f"{WGMMA} takes m <= {WGMMA_MAX_PLANES}, got m={m}")
    if kernel == MMA_SYNC and m > MMA_SYNC_MAX_PLANES:
        raise ValueError(f"{MMA_SYNC} takes m <= {MMA_SYNC_MAX_PLANES}, "
                         f"got m={m}")
    _build.require_hopper(dev, kernel)
    fn = _entry(kernel)
    a_km = _kernel_operand(a_km)
    b_km = _kernel_operand(b_km)
    K = a_km.shape[2]
    out = torch.empty((2 * m - 1, M, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_km.data_ptr(), b_km.data_ptr(), out.data_ptr(), m, M, N, K,
                 stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error; 10000 + a CUresult: a TMA "
                           f"tensor map was refused) (m={m} M={M} N={N} "
                           f"K={K})")
    launches += 1
    kernel_launches[kernel] += 1
    return out


def layered_matmul_kmajor(a_km: torch.Tensor, b_km: torch.Tensor, *,
                          m: int) -> torch.Tensor:
    """Per-layer int32 partials from K-major int8 planes.

    a_km: (m, M, K) int8   b_km: (m, N, K) int8   ->   (L, M, N) int32.
    CUDA tensors launch :func:`kernel_for`'s kernel, CPU tensors run the
    plain version.
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
