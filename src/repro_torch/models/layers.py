"""Shared neural-net layers: norms, RoPE, GQA attention, initialisers.

Pure functions over explicit parameter dicts, as in the JAX package's
``models/layers.py``.  Attention is grouped-query throughout: queries are
reshaped to ``(B, S, n_kv, group, head_dim)`` so K/V are never repeated.
:func:`attention` is the plain general function (any positions, optional
``kv_valid`` mask, logit softcap); the models' full-sequence self-attention
goes to the flash kernel instead (``models/transformer.py``), and decode
stays :func:`decode_attention`, which the JAX package has no kernel for.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import AttentionConfig

__all__ = [
    "rms_norm", "layer_norm", "apply_norm", "rope", "attention",
    "decode_attention", "mlp_swiglu", "init_linear", "init_norm",
]

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dtype)


def apply_norm(norm_kind: str, x: torch.Tensor, params: dict) -> torch.Tensor:
    if norm_kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply RoPE to ``x (..., S, n, head_dim)`` given ``positions (..., S)``."""
    head_dim = x.shape[-1]
    fraction = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=x.device) / head_dim)
    timescale = theta ** fraction                      # (head_dim/2,)
    angles = (positions[..., None].to(torch.float32)
              / timescale[None, :])                    # (..., S, head_dim/2)
    angles = angles[..., None, :]                      # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (grouped-query; full / causal / sliding-window)
# ---------------------------------------------------------------------------

def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: Optional[int],
               kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 1, 1, Sq, Skv) additive mask bias from position comparisons."""
    dq, dk = pos_q[..., :, None], pos_k[..., None, :]
    ok = torch.ones(dq.shape[:-1] + dk.shape[-1:], dtype=torch.bool,
                    device=pos_q.device)
    if causal:
        ok = ok & (dk <= dq)
    if window is not None:
        ok = ok & (dk > dq - window)
    if kv_valid is not None:
        ok = ok & kv_valid[..., None, :]
    bias = torch.where(ok, 0.0, _NEG_INF)
    # (B, Sq, Skv) -> (B, 1, 1, Sq, Skv): broadcasts over (n_kv, G)
    return bias[..., None, None, :, :]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Grouped attention core.

    q: (B, Sq, n_kv, G, Dh); k, v: (B, Skv, n_kv, Dh); bias broadcastable
    to (B, n_kv, G, Sq, Skv).  Logits and softmax in fp32 (the JAX
    package's ``preferred_element_type``), probabilities cast to v's
    dtype.  Returns (B, Sq, n_kv, G, Dh).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos_q: torch.Tensor, pos_k: torch.Tensor, cfg: AttentionConfig,
              *, q_chunk: int = 2048,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention for train/prefill, the plain general function.

    q: (B, Sq, n_heads, Dh); k/v: (B, Skv, n_kv, Dh); positions are (B, S).
    Query-chunked when Sq > q_chunk so scores never materialise at S^2.
    Returns (B, Sq, n_heads, Dh).
    """
    B, Sq, H, Dh = q.shape
    n_kv, G = cfg.num_kv_heads, cfg.group_size
    qg = q.reshape(B, Sq, n_kv, G, Dh)

    def block(q_blk, pos_blk):
        bias = _mask_bias(pos_blk, pos_k, cfg.causal, cfg.window, kv_valid)
        return _attend(q_blk, k, v, bias, cfg.attn_logit_softcap)

    if Sq <= q_chunk:
        out = block(qg, pos_q)
    else:
        if Sq % q_chunk:
            raise ValueError(f"Sq={Sq} not a multiple of q_chunk={q_chunk}")
        out = torch.cat([block(qg[:, i:i + q_chunk], pos_q[:, i:i + q_chunk])
                         for i in range(0, Sq, q_chunk)], dim=1)
    return out.reshape(B, Sq, H, Dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     cfg: AttentionConfig,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a (B, S_cache, n_kv, Dh) KV cache.

    q: (B, 1, n_heads, Dh); ``pos`` (B,) is the new token's position;
    ``cache_len`` (B,) marks how many cache slots are valid.
    """
    B, _, H, Dh = q.shape
    n_kv, G = cfg.num_kv_heads, cfg.group_size
    S = k_cache.shape[1]
    qg = q.reshape(B, 1, n_kv, G, Dh)
    slots = torch.arange(S, dtype=torch.int64, device=q.device)[None, :]
    valid = slots < cache_len[:, None]
    if cfg.window is not None:
        valid = valid & (slots > (pos[:, None] - cfg.window))
    bias = torch.where(valid, 0.0, _NEG_INF)[:, None, None, None, :]
    out = _attend(qg, k_cache, v_cache, bias, cfg.attn_logit_softcap)
    return out.reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
# Initializers (seeded by a torch.Generator; the numbers differ from the
# JAX package's jax.random draws — parity tests carry JAX weights over with
# models.convert instead)
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, extra_dims: tuple[int, ...] = (),
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Weights on ``device`` (the card unless the caller asks for the CPU),
    drawn from ``gen``, which must live there too."""
    shape = extra_dims + (d_in, d_out)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=resolve_device(device))
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def init_norm(d: int, dtype: torch.dtype, kind: str = "rmsnorm",
              extra_dims: tuple[int, ...] = (),
              device: torch.device | str = "cuda") -> dict:
    """Norm parameters on ``device`` (the card unless the caller asks for
    the CPU)."""
    shape = extra_dims + (d,)
    device = resolve_device(device)
    if kind == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}
