"""Shared neural-net layers: norms, RoPE, GQA attention, initialisers.

Pure functions over explicit parameter dicts, as in the JAX package's
``models/layers.py``.  Attention is grouped-query throughout: queries are
reshaped to ``(B, S, n_kv, group, head_dim)`` so K/V are never repeated.
:func:`attention` is the plain general function (any positions, optional
``kv_valid`` mask, logit softcap); the models' full-sequence self-attention
goes to the flash kernel instead (``models/transformer.py``), and
:func:`decode_attention` to the decode-attention kernel
(``kernels.ops.decode_attention``), which the JAX package has no kernel
for.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import resolve_device
from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.launch.axes import constrain, einsum, local_shards, spec_of

__all__ = [
    "rms_norm", "layer_norm", "apply_norm", "rope", "attention",
    "decode_attention", "mlp_swiglu", "mlp_gelu", "init_linear",
    "init_norm",
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


def apply_norm(norm_kind: str, x: torch.Tensor, params: dict,
               eps: Optional[float] = None) -> torch.Tensor:
    """The config's norm; ``eps`` None takes each norm's own default."""
    kw = {} if eps is None else {"eps": eps}
    if norm_kind == "rmsnorm":
        return rms_norm(x, params["scale"], **kw)
    return layer_norm(x, params["scale"], params["bias"], **kw)


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


def group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (B, S, H, Dh) as (B, S, n_kv, H // n_kv, Dh).

    DTensor splits a sharded head dim only where ``n_kv`` divides its
    ranks; where it does not, the heads of a DTensor are gathered first.
    """
    B, S, H, Dh = q.shape
    if isinstance(q, DTensor):
        sizes = q.device_mesh.shape
        split = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
        if split and n_kv % math.prod(sizes[i] for i in split):
            q = q.redistribute(q.device_mesh, [
                Replicate() if i in split else p
                for i, p in enumerate(q.placements)])
    return q.reshape(B, S, n_kv, H // n_kv, Dh)


def _add_bias(logits: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``logits + bias``.  On DTensor logits each rank adds the bias of
    its own shard: the bias is laid out like the logits on every dim it
    does not broadcast over (a key dim split over ranks, as a
    context-parallel KV cache splits it), where DTensor's own broadcast
    of a whole bias against split logits differs between releases."""
    if not isinstance(logits, DTensor):
        return logits + bias
    mesh = logits.device_mesh
    spec = spec_of(logits)
    if not isinstance(bias, DTensor):
        bias = DTensor.from_local(bias, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    bspec = tuple(None if n == 1 else s for n, s in zip(bias.shape, spec))
    return local_shards(torch.add, mesh, (logits, bias), (spec, bspec),
                        (tuple(logits.shape), spec))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Grouped attention core.

    q: (B, Sq, n_kv, G, Dh); k, v: (B, Skv, n_kv, Dh); bias broadcastable
    to (B, n_kv, G, Sq, Skv).  Logits and softmax in fp32 (the JAX
    package's ``preferred_element_type``), probabilities cast to v's
    dtype.  Returns (B, Sq, n_kv, G, Dh).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = _add_bias(logits, bias)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return einsum("bhgqk,bkhd->bqhgd", probs, v)


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
    qg = group_heads(q, cfg.num_kv_heads)

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
    ``cache_len`` (B,) marks how many cache slots are valid.  The config's
    window and logit softcap apply (``kernels.ops.decode_attention``: the
    decode-attention kernel on the card, the plain version elsewhere).
    """
    return ops.decode_attention(q, k_cache, v_cache, pos, cache_len,
                                window=cfg.window,
                                softcap=cfg.attn_logit_softcap)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_gelu(x: torch.Tensor, w_fc: torch.Tensor, b_fc: torch.Tensor,
             w_proj: torch.Tensor, b_proj: torch.Tensor) -> torch.Tensor:
    """GELU (tanh) MLP with biases.  The hidden activation is pinned to
    ``(batch, ..., tp)`` (``launch.axes.constrain``, a no-op off a mesh),
    where the reference's inline copy in its transformer pins it."""
    h = F.gelu(x @ w_fc + b_fc, approximate="tanh")
    h = constrain(h, "batch", None, "tp")
    return h @ w_proj + b_proj


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
