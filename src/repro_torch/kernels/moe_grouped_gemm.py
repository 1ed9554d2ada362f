"""Products grouped by expert over row counts the device holds: one CUDA
kernel (``csrc/moe_grouped_gemm.cu``) and its plain version.

Replaces no TPU kernel: the JAX package's experts are the GShard einsums
over capacity buffers (``src/repro/models/moe.py``), which have a dense
form.  The port's dropless expert layer (``models.moe.dropless_moe``) has
none that fits: its rows are sorted by expert and each expert's count is
known only on the device, changing every decode step, so a padded ``bmm``
would pad every held expert to every pair of the step.  This kernel takes
the counts where they are.

``a (M, K)`` holds rows sorted by expert, expert ``e``'s rows
``offsets[e]:offsets[e + 1]`` (``offsets (E + 1,)`` int32 on the device,
``offsets[E] <= M``); ``w (E, K, N)`` the experts' weights stacked on a
leading axis.  The result ``(M, N)`` is each row times its expert's
weight, accumulated in fp32 and written in ``a``'s type; with ``w_up`` it
is ``silu(a w) * (a w_up)``, the SwiGLU's gated product, taken in fp32
before the rounding.  Rows past ``offsets[E]`` are zero.

On a CUDA tensor :func:`moe_grouped_gemm_kernel_call` launches the kernel
(bf16, K and N multiples of 64) or raises; on a CPU tensor the wrapper in
``kernels.ops`` runs :func:`moe_grouped_gemm_plain`.  :data:`launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["moe_grouped_gemm_plain", "moe_grouped_gemm_kernel_call",
           "tile_rows", "launches", "KERNEL", "ALIGN", "flops",
           "min_bytes"]

KERNEL = "moe_grouped_gemm"

#: K and N must be multiples of this (the kernel's 64-wide tiles)
ALIGN = 64

#: rows a tile of the kernel's two variants takes: 16 where the experts
#: get few rows each (a decode step), 128 where they get many (a prefill)
SMALL_ROWS, LARGE_ROWS = 16, 128

#: Kernel launches so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_bound: dict = {}


def flops(rows: int, K: int, N: int, gated: bool) -> float:
    """Floating-point operations of one call on ``rows`` held rows: 2 K N
    a row, twice with ``gated``."""
    return 2.0 * rows * K * N * (2 if gated else 1)


def min_bytes(rows: int, experts: int, K: int, N: int, gated: bool,
              elem: int = 2) -> float:
    """Bytes one call must move: the weights of the ``experts`` that got
    a row, once (twice as many with ``gated``), each row in and out once."""
    mats = 2 if gated else 1
    return elem * (experts * K * N * mats + rows * (K + N))


def tile_rows(M: int, E: int) -> int:
    """The rows of a tile for ``M`` rows over ``E`` experts: 16 at up to
    32 rows an expert on average, else 128."""
    return SMALL_ROWS if M <= 32 * E else LARGE_ROWS


def _work_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def moe_grouped_gemm_plain(a: torch.Tensor, w: torch.Tensor,
                           offsets: torch.Tensor,
                           w_up: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The kernel's function in PyTorch, expert by expert (reads the
    offsets on the host): fp32 products (float64 for float64 rows), the
    gated product's activation in that precision, the result in ``a``'s
    type, rows of no expert zero."""
    M, N = a.shape[0], w.shape[-1]
    wd = _work_dtype(a)
    out = torch.zeros((M, N), dtype=a.dtype, device=a.device)
    off = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi <= lo:
            continue
        x = a[lo:hi].to(wd)
        y = x @ w[e].to(wd)
        if w_up is not None:
            y = F.silu(y) * (x @ w_up[e].to(wd))
        out[lo:hi] = y.to(a.dtype)
    return out


def _entry():
    fn = _bound.get(KERNEL)
    if fn is None:
        fn = getattr(_build.load(KERNEL), "moe_grouped_gemm")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[KERNEL] = fn
    return fn


def moe_grouped_gemm_kernel_call(a: torch.Tensor, w: torch.Tensor,
                                 offsets: torch.Tensor,
                                 w_up: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Launch the kernel on the card for ``a (M, K)``, ``w (E, K, N)`` (and
    ``w_up`` alike), ``offsets (E + 1,)`` int32, all on one card; returns
    ``(M, N)`` in bf16.  Raises for what the kernel does not take and for
    a failed launch; never falls back."""
    global launches
    dev = a.device
    if a.dim() != 2 or w.dim() != 3:
        raise ValueError(f"moe_grouped_gemm takes a (M, K) and w (E, K, N), "
                         f"got {tuple(a.shape)} and {tuple(w.shape)}")
    M, K = a.shape
    E, _, N = w.shape
    tensors = [a, w, offsets] + ([] if w_up is None else [w_up])
    if any(t.device != dev for t in tensors):
        raise ValueError("moe_grouped_gemm inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (
            w_up is not None and w_up.dtype != torch.bfloat16):
        raise TypeError(f"moe_grouped_gemm kernel takes bfloat16 rows and "
                        f"weights, got {a.dtype} and {w.dtype}")
    if w.shape[1] != K or (w_up is not None and w_up.shape != w.shape):
        raise ValueError(f"weights {tuple(w.shape)} do not take rows of {K}")
    if K % ALIGN or N % ALIGN:
        raise ValueError(f"moe_grouped_gemm kernel takes K and N multiples "
                         f"of {ALIGN}, got K={K} N={N}")
    if offsets.dtype != torch.int32 or offsets.shape != (E + 1,):
        raise ValueError(f"offsets must be int32 of shape ({E + 1},), got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if not 1 <= E <= 1024:
        raise ValueError(f"moe_grouped_gemm kernel takes 1..1024 experts, "
                         f"got {E}")
    _build.require_hopper(dev, "moe_grouped_gemm")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return out
    a, w, offsets = a.contiguous(), w.contiguous(), offsets.contiguous()
    w2 = None if w_up is None else w_up.contiguous()
    if any(t.data_ptr() % 16 for t in (a, w, w2) if t is not None):
        raise ValueError("moe_grouped_gemm kernel reads 16-byte aligned "
                         "rows and weights")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(a.data_ptr(), w.data_ptr(),
                       None if w2 is None else w2.data_ptr(),
                       offsets.data_ptr(), out.data_ptr(), M, K, N, E,
                       tile_rows(M, E), stream)
    if err != 0:
        raise RuntimeError(f"moe_grouped_gemm launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
