"""Public wrappers around the port's kernels.

Functions on tensors follow the tensor's device: CUDA tensors launch the
hand-written kernels, CPU tensors run their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import layering
# flash_attention(q, k, v, *, causal=True, window=None) for (B, S, H, dh)
# tensors with GQA: kv head h // (H // n_kv) is read in place, no repeat
from repro_torch.kernels.flash_attention import \
    flash_attention_gqa as flash_attention
from repro_torch.kernels.layered_matmul import K_ALIGN, layered_matmul_kmajor
from repro_torch.kernels.ssd_scan import ssd_scan_kernel_call

__all__ = ["layered_matmul", "layered_matmul_partials", "flash_attention",
           "ssd_scan_fused"]


def _planes_kmajor(x: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """int8 digit planes of ``x (K, R)``, K-major: ``(m, R, Kp)``.

    ``Kp`` is K rounded up to :data:`K_ALIGN`; the pad is zeros, which add
    nothing to a partial, so the kernels read whole 16-byte rows.  Each
    digit is computed in int32 in ``x``'s own layout
    (:func:`~repro_torch.core.layering.digit`: one pass, two for a middle
    plane), then one ``copy_`` transposes it and wraps it to int8 into its
    slice of the output: ``decompose(x.T).to(torch.int8)`` without
    decompose's stacked int32 copy.  The int32 digit is not written into an
    int8 ``out=`` directly: on CUDA such an op computes in int8.
    """
    K, R = x.shape
    xt = x.to(torch.int32).T
    out = torch.empty((m, R, -(-K // K_ALIGN) * K_ALIGN), dtype=torch.int8,
                      device=x.device)
    out[:, :, K:].zero_()
    for i in range(m):
        out[i, :, :K].copy_(layering.digit(xt, i, m, d))
    return out


def layered_matmul_partials(a: torch.Tensor, b: torch.Tensor, *, m: int = 2,
                            d: int = 7) -> torch.Tensor:
    """Exact int32 per-layer partials of ``a.T @ b`` (the worker compute).

    Decomposes integer a (K, M), b (K, N) into int8 digit planes (d <= 7 so
    unsigned digits fit int8) and runs the fused kernel.  Row ``l`` is
    the unscaled layer-l partial sum -- exact as long as
    ``J(l) * K * (2^d - 1)^2 < 2^31``.  Operands outside ``m * d`` signed
    bits wrap in the int8 cast, exactly as the reference's do.
    """
    if d > 7:
        raise ValueError("d <= 7 required for int8 digit planes")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"contraction dims differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return layered_matmul_kmajor(_planes_kmajor(a, m, d),
                                 _planes_kmajor(b, m, d), m=m)


def layered_matmul(a: torch.Tensor, b: torch.Tensor, *, m: int = 2,
                   d: int = 7) -> torch.Tensor:
    """Layered Definition-1 resolutions of ``a.T @ b``.

    Kernel partials + fp32 fusion (scale by ``2**((i+j) d)`` + cumulative
    sum).  Returns (L, M, N) float32; the final row equals the exact
    product for magnitudes within fp32's 2^24 integer range -- callers
    needing bit-exact fusion use :func:`layered_matmul_partials` and fuse
    in int64/fp64 on the host.
    """
    partials = layered_matmul_partials(a, b, m=m, d=d)
    L = partials.shape[0]
    scales = torch.tensor([float(1 << ((2 * m - 2 - l) * d))
                           for l in range(L)], dtype=torch.float32,
                          device=partials.device)
    scaled = partials.to(torch.float32) * scales[:, None, None]
    return torch.cumsum(scaled, dim=0)


def ssd_scan_fused(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None):
    """Fused-SSD twin of ``repro_torch.models.ssm.ssd_scan`` (G = 1 only).

    x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, 1, N), init_state
    (B, H, P, N) or None -> (y (B, S, H, P) fp32, final_state (B, H, P, N)
    fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if Bm.shape[-2] != 1 or Cm.shape[-2] != 1:
        raise ValueError(f"one B/C group only, got Bm {tuple(Bm.shape)}")
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    nc = S // chunk
    y, state = ssd_scan_kernel_call(
        x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), A,
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N),
        init_state=init_state)
    return y.reshape(B, S, H, P), state
