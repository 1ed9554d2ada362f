"""Pieces every plain reference shares: float32 matmuls (or their fp8
control), the norm, rotary embeddings, the layered LM head and the gaps.

Plain PyTorch, written from the papers' equations; nothing here imports
the program.  A reference runs in float32 with TF32 off unless it is the
control, which rounds both operands of every weight matmul to fp8 (e4m3,
one scale per tensor) and multiplies them in float32: the precision
below the configurations' bfloat16.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Precision", "rms_norm", "rope", "released_weight", "gaps",
           "argmax_gaps", "no_tf32"]

#: largest finite e4m3 value
_E4M3_MAX = 448.0


def no_tf32() -> None:
    """float32 matmuls in float32 on the card (TF32 would be a lower
    precision than the reference claims)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale for the tensor (its largest
    magnitude maps to 448), back in float32; under autograd the rounding
    passes the gradient straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = _E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


class Precision:
    """How a reference multiplies by its weights: ``"fp32"`` or ``"fp8"``
    (the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(torch.float32), w.to(torch.float32)
        if self.name == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm whose weight is stored as its offset from one (the
    parameter tree stores ``scale``; the norm multiplies by ``1 + scale``)."""
    x = x.to(torch.float32)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
            * (1.0 + scale.to(torch.float32)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x (S, heads, dh)`` at positions ``0..S-1``:
    the first and second halves of each head are the pairs rotated, by
    angle ``p / theta^(2i/dh)``."""
    S, _, dh = x.shape
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv[None, :]).to(torch.float32)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def released_weight(w: torch.Tensor, m: int, d: int,
                    release: int) -> torch.Tensor:
    """The weight a layered head releases at resolution ``release`` of
    ``m`` (paper §III): ``w`` quantized symmetrically to ``m d`` signed bits
    at one scale (its largest magnitude maps to ``2^(md-1) - 1``), with the
    ``(m - release) d`` low bits cleared (a floor, as the arithmetic shift
    of two's complement digits), back in float32."""
    if not 1 <= release <= m:
        raise ValueError(f"release {release} outside 1..{m}")
    w = w.to(torch.float32)
    qmax = float(2 ** (m * d - 1) - 1)
    scale = w.abs().max().clamp(min=1e-30) / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    step = float(2 ** ((m - release) * d))
    return torch.floor(q / step) * step * scale


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each served token's logit lies below the best one of
    its row: ``logits (n, V)``, ``tokens (n,)`` -> ``(n,)``, 0 where the
    token is the best."""
    picked = logits.gather(-1, tokens.long()[:, None])[:, 0]
    return logits.max(dim=-1).values - picked


def argmax_gaps(logits: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """The gaps in ``logits`` of the tokens that ``other`` (logits of the
    same rows computed otherwise) puts first."""
    return gaps(logits, other.argmax(dim=-1))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention in float32, query block by block:
    ``q (S, H, dh)``, ``k, v (S, kv, dh)``; head ``h`` reads kv head
    ``h // (H / kv)``.  Returns ``(S, H, dh)``."""
    S, H, dh = q.shape
    kv = k.shape[1]
    g = H // kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * scale
        mask = (torch.arange(hi, device=q.device)[None, :]
                > torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                  v[:hi])
    return out
