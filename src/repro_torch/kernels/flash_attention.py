"""Flash attention: CUDA kernel + plain version.

Port of the TPU kernel ``flash_attention_kernel_call``
(``src/repro/kernels/flash_attention.py:85``): online-softmax attention
with fp32 math, the finite mask value ``-0.7 * f32max``, the causal skip of
key blocks above the diagonal, an optional sliding window
(``kpos > qpos - window``) and the denominator clamped at 1e-30; output in
q's dtype.  Positions are the row indices: query ``i`` and key ``j`` sit
at positions ``i`` and ``j``.

On a CUDA tensor the wrappers launch the hand-written Hopper kernel
``csrc/flash_attention.cu`` (one CTA per 64-row query tile, the key loop
inside the block; see the source for what bounds it).  It reads GQA K/V
in place through their strides, takes fp32 or bf16 and head dims that are
multiples of 16 up to 128, and any ``Sq``/``Skv``.  On a CPU tensor the
wrappers run :func:`flash_attention_plain`.  There is no fallback between
the two: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["NEG_INF", "flash_attention_plain", "flash_attention_kernel_call",
           "flash_attention_gqa", "flash_attention_gqa_plain", "launches"]

#: The TPU kernel's finite mask value (a fully masked row stays finite).
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: Kernel launches so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_SOURCE = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_bound = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention over ``(BH, S, dh)``: fp32 math, q's dtype
    out (the JAX package's ``kernels/ref.py:36`` in PyTorch)."""
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", q32, k32) / math.sqrt(q.shape[-1])
    Sq, Skv = s.shape[-2], s.shape[-1]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v32).to(q.dtype)


def _entry():
    global _bound
    if _bound is None:
        fn = _build.load(_SOURCE).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    """``(B, Sq, H, dh)`` q and ``(B, Skv, n_kv, dh)`` k/v on the card."""
    global launches
    dev = q.device
    B, Sq, H, dh = q.shape
    _, Skv, n_kv, _ = k.shape
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v on different devices: {dev}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"kernel takes head dims 16..128 in steps of 16, "
                         f"got {dh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along head_dim")
    _build.require_hopper(dev, _SOURCE)
    fn = _entry()
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], B, Sq, Skv, H, n_kv, dh, strides,
                 int(causal), 0 if window is None else int(window),
                 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={B} Sq={Sq} Skv={Skv} H={H} "
                           f"n_kv={n_kv} dh={dh})")
    launches += 1
    return out


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, dh) and k = v (B, Skv, n_kv, "
                         f"dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head_dim, heads % kv heads)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Attention for ``(B, S, H, dh)`` q and ``(B, S, n_kv, dh)`` k/v.

    Query head ``h`` attends with kv head ``h // (H // n_kv)``.  CUDA
    tensors launch the kernel, CPU tensors run
    :func:`flash_attention_gqa_plain`.
    """
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if not all(t.device.type == "cpu" for t in (q, k, v)):
        raise ValueError(f"unsupported devices {q.device}/{k.device}/"
                         f"{v.device}")
    return flash_attention_gqa_plain(q, k, v, causal=causal, window=window)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_gqa`'s plain version on any device: K/V
    broadcast to H heads, then :func:`flash_attention_plain`."""
    B, Sq, H, dh = q.shape
    Skv, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv

    def heads(t, S):      # (B, S, n_kv, dh) -> (B*H, S, dh)
        t = t.permute(0, 2, 1, 3)[:, :, None].expand(B, n_kv, G, S, dh)
        return t.reshape(B * H, S, dh)

    out = flash_attention_plain(q.permute(0, 2, 1, 3).reshape(B * H, Sq, dh),
                                heads(k, Skv), heads(v, Skv),
                                causal=causal, window=window)
    return out.reshape(B, H, Sq, dh).permute(0, 2, 1, 3)


def flash_attention_kernel_call(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Attention over ``(BH, S, dh)`` tensors (the TPU kernel's layout):
    q ``(BH, Sq, dh)``, k/v ``(BH, Skv, dh)`` -> ``(BH, Sq, dh)``."""
    if q.ndim != 3:
        raise ValueError(f"want (BH, S, dh) tensors, got {tuple(q.shape)}")
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window)[:, :, 0]
