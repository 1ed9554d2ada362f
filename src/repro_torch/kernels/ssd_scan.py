"""Fused Mamba2 SSD chunk scan (one B/C group): two CUDA kernels + plain
version.

Port of the TPU kernel ``ssd_scan_kernel_call``
(``src/repro/kernels/ssd_scan.py:84``).  Over chunked inputs it runs, for
each (batch, head), the chunk recurrence

    y_diag = ((C B^T) o L) (dt x),   L[i,j] = exp(acum_i - acum_j), i >= j
    y_off  = (C state^T) o exp(acum)
    state  = state * exp(acum[-1]) + ((dt x) o exp(acum[-1] - acum))^T B

with the ``(P, N)`` fp32 state carried across chunks, and returns ``y``
and the final state in fp32.  The TPU kernel starts from a zero state;
here an optional ``init_state`` seeds it (zero when absent), so the
model's ``ssd_scan(..., init_state)`` has a kernel counterpart.

On a CUDA tensor :func:`ssd_scan_kernel_call` launches one of two
hand-written Hopper kernels, chosen by :func:`kernel_for` from
``(dtype, P, N, chunk)``:

- ``ssd_scan_wgmma`` (``csrc/ssd_scan_wgmma.cu``): bf16 ``x``/``B``/``C``
  with P = 64, N = 128 and chunks of 64..256 in steps of 64, the model's
  prefill path (mamba2's head and state widths).  Every product on the
  tensor cores, the fp32 operands split into three bf16 terms, the chunks
  in parallel: a state pass and an output pass, two device kernels per
  call.  ``x``, ``B`` and ``C`` are read as they are, with no widening
  copy.
- ``ssd_scan`` (``csrc/ssd_scan.cu``): fp32, and bf16 with other shapes
  (head dims up to 64 and state sizes up to 128, multiples of 4).  fp32
  FMAs on the CUDA cores, one CTA per (batch, head) with the chunk loop
  inside it; the wrapper first casts each input that is not contiguous
  fp32.

Both are held against the same plain version.  On a CPU tensor the
wrapper runs :func:`ssd_scan_plain`.  There is no fallback: a CUDA tensor
that neither kernel takes raises, and so does a failed launch.
:data:`launches` counts every call that launches a kernel;
:data:`kernel_launches` counts them per kernel source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan_plain", "ssd_scan_kernel_call", "kernel_for",
           "KERNELS", "launches", "kernel_launches", "MAX_HEAD_DIM",
           "MAX_STATE", "flops"]

#: Largest head_dim (P) and d_state (N) the kernels are built for.
MAX_HEAD_DIM = 64
MAX_STATE = 128

#: The two kernels, by source name (``csrc/<name>.cu``).
WGMMA = "ssd_scan_wgmma"
CUDA_CORE = "ssd_scan"
KERNELS = (WGMMA, CUDA_CORE)

#: Kernel launches so far, of both kernels (incremented only where a CUDA
#: kernel is launched; a caller resets it to 0 to count one run).
launches = 0
#: The same count per kernel; a caller resets each entry to 0 with it.
kernel_launches = dict.fromkeys(KERNELS, 0)



def flops(B: int, nc: int, l: int, H: int, P: int, N: int) -> float:
    """Floating-point operations of one scan of ``nc`` chunks of ``l``
    with one B/C group: per (batch, chunk) the scores C B^T once for all
    heads on the ``l (l + 1) / 2`` pairs i >= j (2 N each); per (batch,
    head, chunk) the masked scores times dt x on those pairs (2 P each),
    C state^T and the state update (2 l N P each)."""
    pairs = l * (l + 1) // 2
    return (2.0 * pairs * N * B * nc
            + (2.0 * pairs * P + 4.0 * l * N * P) * B * H * nc)


_DTYPES = (torch.float32, torch.bfloat16)
_WGMMA_CHUNK_STEP = 64
_WGMMA_MAX_CHUNK = 256
_bound: dict = {}


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None):
    """The chunk recurrence in PyTorch, chunk by chunk, on any device.

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N),
    init_state (B, H, P, N) or None -> (y (B, nc, l, H, P), state
    (B, H, P, N)), both fp32.
    """
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    A = A.to(f32)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32).clone())
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c in range(nc):
        xdt = x[:, c] * dt[:, c, :, :, None]                 # (B, l, H, P)
        acum = torch.cumsum(A * dt[:, c], dim=1)             # (B, l, H)
        diff = acum[:, :, None, :] - acum[:, None, :, :]     # (B, l, l, H)
        # masked before the exp, as the reference's _segsum: above the
        # diagonal diff > 0 overflows exp, and where(mask, exp(diff), 0)
        # would carry 0 * inf = NaN into the gradient
        Lmat = torch.exp(torch.where(causal[None, :, :, None], diff,
                                     float("-inf")))
        scores = torch.einsum("bin,bjn->bij", Cm[:, c], Bm[:, c])
        y_diag = torch.einsum("bij,bijh,bjhp->bihp", scores, Lmat, xdt)
        y_off = (torch.einsum("bin,bhpn->bihp", Cm[:, c], state)
                 * torch.exp(acum)[..., None])
        ys.append(y_diag + y_off)
        decay = torch.exp(acum[:, -1:, :] - acum)            # (B, l, H)
        contrib = torch.einsum("bjhp,bjn->bhpn", xdt * decay[..., None],
                               Bm[:, c])
        state = state * torch.exp(acum[:, -1, :])[:, :, None, None] + contrib
    return torch.stack(ys, dim=1), state


def kernel_for(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel that takes ``x``/``B``/``C`` of ``dtype`` with head dim
    ``P``, state size ``N`` and ``chunk`` steps a chunk, on the card.

    bf16 with P = 64, N = 128 and a chunk of 64..256 in steps of 64 ->
    :data:`WGMMA` (tensor cores); fp32, and bf16 with other shapes ->
    :data:`CUDA_CORE`.  Raises ``TypeError`` for another dtype and
    ``ValueError`` for P or N that neither kernel takes.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if P > MAX_HEAD_DIM or N > MAX_STATE or P % 4 or N % 4 or P < 4 or N < 4:
        raise ValueError(f"ssd_scan kernels take head_dim <= {MAX_HEAD_DIM} "
                         f"and d_state <= {MAX_STATE}, multiples of 4; got "
                         f"P={P} N={N}")
    if (dtype == torch.bfloat16 and P == MAX_HEAD_DIM and N == MAX_STATE
            and chunk % _WGMMA_CHUNK_STEP == 0
            and 0 < chunk <= _WGMMA_MAX_CHUNK):
        return WGMMA
    return CUDA_CORE


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_fwd")
        # the tensor-core entry takes a scratch buffer after the state
        n_ptrs = 9 if name == WGMMA else 8
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` packed, from a 16-byte aligned base (as TMA reads it): as it
    is when it already is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, dt, A, Bm, Cm, init_state):
    """Chunked inputs on the card, through :func:`kernel_for`'s choice."""
    global launches
    dev = x.device
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    tensors = [x, dt, A, Bm, Cm] + ([] if init_state is None
                                    else [init_state])
    if any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype not in _DTYPES for t in (x, Bm, Cm)):
        raise TypeError(f"ssd_scan kernels take float32 or bfloat16 x, B "
                        f"and C, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    # x, B and C all bf16 take the bf16 route; a mix takes the fp32 one
    dtype = x.dtype if Bm.dtype == Cm.dtype == x.dtype else torch.float32
    kernel = kernel_for(dtype, P, N, l)
    _build.require_hopper(dev, kernel)
    fn = _entry(kernel)
    if kernel == WGMMA:
        x, Bm, Cm = (_tma_operand(t) for t in (x, Bm, Cm))
    else:
        x, Bm, Cm = (_f32(t) for t in (x, Bm, Cm))
    dt, A = _f32(dt), _f32(A)
    init = None if init_state is None else _f32(init_state)
    y = torch.empty((Bsz, nc, l, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    # the tensor-core kernel's scratch: the state entering each chunk,
    # held here (as y and state are) until both launches are queued
    states = (torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                          device=dev) if kernel == WGMMA else None)
    scratch = () if states is None else (states.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), None if init is None else init.data_ptr(),
                 y.data_ptr(), state.data_ptr(), *scratch, Bsz, nc * l, H,
                 P, N, l, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error; 10000 + a CUresult: a TMA "
                           f"tensor map was refused) (B={Bsz} nc={nc} l={l} "
                           f"H={H} P={P} N={N})")
    launches += 1
    kernel_launches[kernel] += 1
    return y, state


def ssd_scan_kernel_call(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         init_state: Optional[torch.Tensor] = None):
    """Fused SSD over chunked inputs (the TPU kernel's layout).

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N)
    (G = 1: shared across heads), init_state (B, H, P, N) or None.
    Returns (y (B, nc, l, H, P) fp32, final_state (B, H, P, N) fp32).
    """
    if x.ndim != 5:
        raise ValueError(f"x must be (B, nc, l, H, P), got {tuple(x.shape)}")
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (dt, (Bsz, nc, l, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bsz, nc, l, N)), "Cm": (Cm, (Bsz, nc, l, N))}
    if init_state is not None:
        want["init_state"] = (init_state, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    if x.device.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, init_state)
    if any(t.device.type != "cpu" for t, _ in want.values()):
        raise ValueError("ssd_scan inputs on different devices")
    return ssd_scan_plain(x, dt, A, Bm, Cm, init_state)
