"""Fused Mamba2 SSD chunk scan (one B/C group): CUDA kernel + plain version.

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

On a CUDA tensor :func:`ssd_scan_kernel_call` launches the hand-written
Hopper kernel ``csrc/ssd_scan.cu`` (one CTA per (batch, head), the chunk
loop inside it; see the source for what bounds it).  The kernel reads
contiguous fp32, so the wrapper first casts each input that is not
already contiguous fp32 (the model's bf16 ``x``, ``B`` and ``C``): one
extra pass over each such input.  It takes head dims up to 64 and state
sizes up to 128, both multiples of 4.  On a CPU tensor the wrapper runs
:func:`ssd_scan_plain`.  There is no fallback between the two: a CUDA
tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan_plain", "ssd_scan_kernel_call", "launches",
           "MAX_HEAD_DIM", "MAX_STATE"]

#: Largest head_dim (P) and d_state (N) the kernel is built for.
MAX_HEAD_DIM = 64
MAX_STATE = 128

#: Kernel launches so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_SOURCE = "ssd_scan"
_bound = None


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
        Lmat = torch.where(causal[None, :, :, None], torch.exp(diff),
                           torch.zeros((), dtype=f32, device=x.device))
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


def _entry():
    global _bound
    if _bound is None:
        fn = _build.load(_SOURCE).ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _launch(x, dt, A, Bm, Cm, init_state):
    global launches
    dev = x.device
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    if P > MAX_HEAD_DIM or N > MAX_STATE or P % 4 or N % 4:
        raise ValueError(f"kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"d_state <= {MAX_STATE}, multiples of 4; got "
                         f"P={P} N={N}")
    tensors = [x, dt, A, Bm, Cm] + ([] if init_state is None
                                    else [init_state])
    if any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    _build.require_hopper(dev, _SOURCE)
    fn = _entry()
    x, dt, A, Bm, Cm = (_f32(t) for t in (x, dt, A, Bm, Cm))
    init = None if init_state is None else _f32(init_state)
    y = torch.empty((Bsz, nc, l, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), None if init is None else init.data_ptr(),
                 y.data_ptr(), state.data_ptr(), Bsz, nc * l, H, P, N, l,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(B={Bsz} nc={nc} l={l} H={H} P={P} N={N})")
    launches += 1
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
