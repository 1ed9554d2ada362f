"""Decoder-LM assembly: pattern-grouped layers, prefill and decode.

The JAX package's ``models/transformer.py`` in PyTorch, for the layer
kinds

  dense       GQA attention + (SwiGLU | GELU) MLP
  moe         GQA attention + routed-experts FFN (``models.moe``)
  ssm         Mamba2 SSD block (``models.ssm``)
  rglru       RG-LRU recurrent block + MLP (``models.rglru``)
  local_attn  sliding-window GQA + MLP (recurrentgemma's attention layers)

An architecture is a sequence of *block groups*, each a repeating
unit of layer kinds; per-group parameters and caches are stacked on a
leading ``repeats`` axis, and where the reference runs ``lax.scan`` over
that axis the port runs a Python loop.  There is no ``constrain``: the
port runs on one device, where the reference's sharding constraints are
no-ops too.

Prefill's full-sequence self-attention runs the flash kernel
(``kernels.ops.flash_attention``: its positions are ``arange(S)``, which
are the positions ``forward`` gives every layer), and the Mamba2 block
runs the SSD scan kernel; decode stays plain PyTorch, as in the JAX
package, which has no kernel for it.

A ``local_attn`` layer's cache is a ring of ``W`` (the window) slots:
position ``p`` lives in slot ``p % W`` and ``pos = -1`` marks an empty
slot.  Where the prompt length is a multiple of ``W`` this is the JAX
package's layout; where it is not, the reference keeps the last ``W``
keys in prompt order and decode overwrites a key still in the window
(ROADMAP R6), which the ring does not.

The ``cross`` kind, the vlm and audio extras and attention logit
softcaps raise ``NotImplementedError``: they are later slices of the port
(ROADMAP §1).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib

__all__ = [
    "block_groups", "init_params", "init_cache", "forward", "prefill",
    "decode_step", "hidden_step", "count_params", "active_params",
]

# Static KV-cache quantization scale (int8 mode), as the reference's.
_KV_SCALE = 24.0
_PORTED_KINDS = ("dense", "moe", "ssm", "rglru", "local_attn")


def _unsupported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    kinds = {k for unit, _ in block_groups(cfg) for k in unit}
    missing = sorted(kinds - set(_PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {missing} are not ported yet "
            f"(ROADMAP §1); the port runs {list(_PORTED_KINDS)}")
    if cfg.num_image_tokens or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the vlm and audio extras are not ported yet "
            f"(ROADMAP §1)")
    if cfg.attention is not None and cfg.attention.attn_logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: attention logit softcap is not supported (the "
            f"flash kernel, like the TPU kernel, has none)")


def _quant_kv(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.kv_cache_dtype != "int8":
        return x
    return torch.clamp(torch.round(x.to(torch.float32) * _KV_SCALE),
                       -127, 127).to(torch.int8)


def _dequant_kv(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if x.dtype != torch.int8:
        return x
    return x.to(cfg.cdtype()) / torch.tensor(_KV_SCALE, dtype=cfg.cdtype(),
                                             device=x.device)


# ---------------------------------------------------------------------------
# Architecture pattern
# ---------------------------------------------------------------------------

def block_groups(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(unit kinds, repeats)] covering cfg.num_layers exactly."""
    Lnum = cfg.num_layers
    if cfg.family == "ssm":
        return [(("ssm",), Lnum)]
    if cfg.family == "hybrid":
        unit = tuple("rglru" if c == "R" else "local_attn"
                     for c in cfg.rglru.block_pattern)
        reps, rem = divmod(Lnum, len(unit))
        groups = [(unit, reps)] if reps else []
        if rem:
            groups.append((unit[:rem], 1))
        return groups
    if cfg.family == "moe" and cfg.moe.interleave_step > 1:
        step = cfg.moe.interleave_step
        if Lnum % step:
            raise ValueError(f"{Lnum} layers not a multiple of {step}")
        unit = tuple("dense" if i < step - 1 else "moe" for i in range(step))
        return [(unit, Lnum // step)]
    if cfg.family == "moe":
        return [(("moe",), Lnum)]
    if cfg.is_encdec:
        return [(("cross",), Lnum)]
    return [(("dense",), Lnum)]


# ---------------------------------------------------------------------------
# Parameter init (torch.Generator; see layers.init_linear)
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, reps: tuple[int, ...], dev) -> dict:
    a = cfg.attention
    dt = cfg.pdtype()
    D = cfg.d_model
    lin = lambda d_in, d_out: L.init_linear(gen, d_in, d_out, dt, reps, dev)
    return {
        "wq": lin(D, a.num_heads * a.head_dim).reshape(
            reps + (D, a.num_heads, a.head_dim)),
        "wk": lin(D, a.num_kv_heads * a.head_dim).reshape(
            reps + (D, a.num_kv_heads, a.head_dim)),
        "wv": lin(D, a.num_kv_heads * a.head_dim).reshape(
            reps + (D, a.num_kv_heads, a.head_dim)),
        "wo": lin(a.num_heads * a.head_dim, D).reshape(
            reps + (a.num_heads, a.head_dim, D)),
    }


def _init_mlp(gen, cfg: ModelConfig, reps: tuple[int, ...], dev) -> dict:
    dt = cfg.pdtype()
    D, Fd = cfg.d_model, cfg.d_ff
    lin = lambda d_in, d_out: L.init_linear(gen, d_in, d_out, dt, reps, dev)
    if cfg.activation == "gelu":
        return {"w_fc": lin(D, Fd),
                "b_fc": torch.zeros(reps + (Fd,), dtype=dt, device=dev),
                "w_proj": lin(Fd, D),
                "b_proj": torch.zeros(reps + (D,), dtype=dt, device=dev)}
    return {"w_gate": lin(D, Fd), "w_up": lin(D, Fd), "w_down": lin(Fd, D)}


def _init_layer(gen, kind: str, cfg: ModelConfig, reps: tuple[int, ...],
                dev) -> dict:
    norm = lambda: L.init_norm(cfg.d_model, cfg.pdtype(), cfg.norm, reps, dev)
    p: dict[str, Any] = {"ln1": norm()}
    if kind in ("dense", "moe", "local_attn"):
        p["attn"] = _init_attn(gen, cfg, reps, dev)
        p["ln2"] = norm()
        p["ffn"] = (moe_lib.init_moe_params(gen, cfg.d_model, cfg.moe,
                                            cfg.pdtype(), reps, dev)
                    if kind == "moe" else _init_mlp(gen, cfg, reps, dev))
    elif kind == "ssm":
        p["ssm"] = ssm_lib.init_ssm_params(gen, cfg.d_model, cfg.ssm,
                                           cfg.pdtype(), reps, dev)
    elif kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru_params(gen, cfg.d_model, cfg.rglru,
                                                 cfg.pdtype(), reps, dev)
        p["ln2"] = norm()
        p["ffn"] = _init_mlp(gen, cfg, reps, dev)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters on ``device`` (the card unless the caller asks for
    the CPU), drawn from a ``torch.Generator`` seeded with ``seed``.

    The same nested dicts and lists as the JAX package's ``init_params``;
    the numbers differ (``models.convert`` carries JAX weights over).  On
    the ``meta`` device only the shapes exist, which is how
    :func:`count_params` counts a config too large to build.
    """
    _unsupported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = cfg.pdtype()
    params: dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              dtype=torch.float32, device=dev) * 0.02
                  ).to(dt),
        "final_norm": L.init_norm(cfg.d_model, dt, cfg.norm, (), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          dt, (), dev)
    params["groups"] = [[_init_layer(gen, kind, cfg, (reps,), dev)
                         for kind in unit]
                        for unit, reps in block_groups(cfg)]
    return params


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, window=None):
    """Projection + flash self-attention + output projection over a full
    sequence at ``positions = arange(S)``.  Returns (out, (k, v))."""
    a = cfg.attention
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = L.rope(q, positions, a.rope_theta)
    k = L.rope(k, positions, a.rope_theta)
    out = ops.flash_attention(q, k, v, causal=a.causal, window=window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)


def _ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
               kind: str) -> torch.Tensor:
    if kind == "moe":
        return moe_lib.moe_block(p, x, cfg.moe)
    if cfg.activation == "gelu":
        h = F.gelu(x @ p["w_fc"].to(x.dtype) + p["b_fc"].to(x.dtype),
                   approximate="tanh")
        return h @ p["w_proj"].to(x.dtype) + p["b_proj"].to(x.dtype)
    h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def _layer_fwd(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """Full-sequence layer forward.  Returns (x, cache_entry)."""
    norm = lambda n, h: L.apply_norm(cfg.norm, h, n)
    if kind in ("dense", "moe", "local_attn"):
        window = (_local_window(cfg) if kind == "local_attn"
                  else cfg.attention.window)
        h, (k, v) = _attn_apply(p["attn"], norm(p["ln1"], x), cfg,
                                positions, window=window)
        x = x + h
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, kind)
        if kind == "local_attn":
            return x, _ring(k, v, positions, window)
        return x, {"k": k, "v": v}
    if kind == "ssm":
        h, cache = ssm_lib.ssm_block(p["ssm"], norm(p["ln1"], x),
                                     cfg.d_model, cfg.ssm)
        return x + h, cache
    if kind == "rglru":
        h, cache = rglru_lib.rglru_block(p["rglru"], norm(p["ln1"], x),
                                         cfg.rglru)
        x = x + h
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, "dense")
        return x, cache
    raise ValueError(kind)


def _local_window(cfg: ModelConfig) -> int:
    return cfg.rglru.window if cfg.rglru else cfg.attention.window


def _ring(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
          W: int) -> dict:
    """A local-attention cache of ``W`` slots holding the last ``W`` keys
    and values of a prompt (positions ``[max(0, S - W), S)``), position
    ``p`` in slot ``p % W``; the other slots empty (``pos = -1``)."""
    B, S = k.shape[:2]
    lo = max(0, S - W)
    slots = torch.arange(lo, S, device=k.device) % W
    kc = k.new_zeros((B, W) + k.shape[2:])
    vc = v.new_zeros((B, W) + v.shape[2:])
    pc = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
    kc[:, slots] = k[:, lo:]
    vc[:, slots] = v[:, lo:]
    pc[:, slots] = positions[:, lo:].to(torch.int32)
    return {"k": kc, "v": vc, "pos": pc}


def _layer_decode(kind: str, p: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig, pos: int):
    """Single-token layer step against a cache.  Returns (x, new_cache).

    The attention KV cache is written in place at slot ``pos`` (the
    reference's ``dynamic_update_slice``); the returned cache holds the
    same tensors.
    """
    norm = lambda n, h: L.apply_norm(cfg.norm, h, n)
    B = x.shape[0]
    pos_b = torch.full((B,), pos, dtype=torch.int64, device=x.device)
    if kind in ("dense", "moe", "local_attn"):
        a = cfg.attention
        hin = norm(p["ln1"], x)
        ap = p["attn"]
        q = torch.einsum("bsd,dhk->bshk", hin, ap["wq"].to(x.dtype))
        k = torch.einsum("bsd,dhk->bshk", hin, ap["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", hin, ap["wv"].to(x.dtype))
        q = L.rope(q, pos_b[:, None], a.rope_theta)
        k = L.rope(k, pos_b[:, None], a.rope_theta)
        if kind == "local_attn":
            # the ring: position pos in slot pos % W; a slot is valid while
            # its position is inside the window ending at pos, and an empty
            # slot (pos -1) never is
            W = _local_window(cfg)
            slot = pos % W
            cache["k"][:, slot:slot + 1] = _quant_kv(k, cfg)
            cache["v"][:, slot:slot + 1] = _quant_kv(v, cfg)
            cache["pos"][:, slot] = pos
            pc = cache["pos"]
            valid = (pc >= 0) & (pc <= pos) & (pc > pos - W)
            bias = torch.where(valid, 0.0, L._NEG_INF)
            qg = q.reshape(B, 1, a.num_kv_heads, a.group_size, a.head_dim)
            out = L._attend(qg, _dequant_kv(cache["k"], cfg),
                            _dequant_kv(cache["v"], cfg),
                            bias[:, None, None, None, :],
                            a.attn_logit_softcap)
            out = out.reshape(B, 1, a.num_heads, a.head_dim)
        else:
            cache["k"][:, pos:pos + 1] = _quant_kv(k, cfg)
            cache["v"][:, pos:pos + 1] = _quant_kv(v, cfg)
            out = L.decode_attention(q, _dequant_kv(cache["k"], cfg),
                                     _dequant_kv(cache["v"], cfg), pos_b, a,
                                     cache_len=pos_b + 1)
        h = torch.einsum("bshk,hkd->bsd", out, ap["wo"].to(x.dtype))
        x = x + h
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, kind)
        return x, cache
    if kind == "ssm":
        h, new_cache = ssm_lib.ssm_decode_step(p["ssm"], norm(p["ln1"], x),
                                               cache, cfg.d_model, cfg.ssm)
        return x + h, new_cache
    if kind == "rglru":
        h, new_cache = rglru_lib.rglru_decode_step(
            p["rglru"], norm(p["ln1"], x), cache, cfg.rglru)
        x = x + h
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, "dense")
        return x, new_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> list:
    """Stacked zero caches aligned with params['groups']."""
    _unsupported(cfg)
    dev = resolve_device(device)
    a = cfg.attention
    dt = cfg.cdtype()
    kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dt
    groups = []
    for unit, reps in block_groups(cfg):
        unit_caches = []
        for kind in unit:
            if kind == "ssm":
                c = ssm_lib.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dt,
                                           dev)
            elif kind == "rglru":
                c = rglru_lib.init_rglru_cache(batch, cfg.d_model, cfg.rglru,
                                               dt, dev)
            elif kind == "local_attn":
                shape = (batch, _local_window(cfg), a.num_kv_heads,
                         a.head_dim)
                c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dt, device=dev),
                     "pos": torch.full(shape[:2], -1, dtype=torch.int32,
                                       device=dev)}
            else:
                shape = (batch, max_len, a.num_kv_heads, a.head_dim)
                c = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
            unit_caches.append({n: t[None].repeat((reps,) + (1,) * t.ndim)
                                for n, t in c.items()})
        groups.append(unit_caches)
    return groups


# ---------------------------------------------------------------------------
# Full passes
# ---------------------------------------------------------------------------

def _embed_inputs(params: dict, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens].to(cfg.cdtype())
    if cfg.family == "hybrid":  # gemma-style embedding scale
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The plain, full-precision LM head on normed hidden states."""
    w = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
         else params["lm_head"].to(x.dtype))
    return x @ w


def _layer_params(group_params: dict, r: int) -> dict:
    """Layer ``r`` of a group's stacked parameters (views)."""
    return {n: (_layer_params(v, r) if isinstance(v, dict) else v[r])
            for n, v in group_params.items()}


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            want_cache: bool = False):
    """Full-sequence forward.  Returns (logits, cache-or-None)."""
    _unsupported(cfg)
    B, S = tokens.shape
    x = _embed_inputs(params, tokens, cfg)
    positions = torch.arange(S, dtype=torch.int64,
                             device=x.device).expand(B, S)
    caches = []
    for g, (unit, reps) in enumerate(block_groups(cfg)):
        per_layer = [[] for _ in unit]
        for r in range(reps):
            for u, kind in enumerate(unit):
                x, c = _layer_fwd(kind, _layer_params(params["groups"][g][u],
                                                      r), x, cfg, positions)
                if want_cache:
                    per_layer[u].append(c)
        if want_cache:
            caches.append([{n: torch.stack([c[n] for c in cs])
                            for n in cs[0]} for cs in per_layer])
    logits = _head(params, L.apply_norm(cfg.norm, x, params["final_norm"]),
                   cfg)
    return logits, (caches if want_cache else None)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int):
    """Run the prompt; returns (last-position logits, caches @ max_len)."""
    logits, caches = forward(params, tokens, cfg, want_cache=True)
    S = tokens.shape[1]
    padded = []
    for g, (unit, _) in enumerate(block_groups(cfg)):
        unit_caches = []
        for u, kind in enumerate(unit):
            c = caches[g][u]
            if kind in ("dense", "moe"):
                # (reps, B, S, n_kv, dh) -> (reps, B, max_len, n_kv, dh)
                c = {n: F.pad(_quant_kv(c[n], cfg),
                              (0, 0, 0, 0, 0, max_len - S))
                     for n in ("k", "v")}
            elif kind == "local_attn":
                c = dict(c, k=_quant_kv(c["k"], cfg),
                         v=_quant_kv(c["v"], cfg))
            unit_caches.append(c)
        padded.append(unit_caches)
    return logits[:, -1, :], padded


def hidden_step(params: dict, token: torch.Tensor, caches: list, pos: int,
                cfg: ModelConfig):
    """One decode step up to the final norm: token (B, 1) at position
    ``pos``.  Returns (normed hidden (B, D), caches).

    Caches are updated in place: the stacked tensors of ``caches`` hold the
    new entries when this returns (the reference donates them instead).
    """
    _unsupported(cfg)
    pos = int(pos)
    x = _embed_inputs(params, token, cfg)
    for g, (unit, reps) in enumerate(block_groups(cfg)):
        for r in range(reps):
            for u, kind in enumerate(unit):
                stacked = caches[g][u]
                layer_cache = {n: t[r] for n, t in stacked.items()}
                x, new = _layer_decode(
                    kind, _layer_params(params["groups"][g][u], r), x,
                    layer_cache, cfg, pos)
                for n, t in new.items():
                    if t is not layer_cache[n]:
                        stacked[n][r].copy_(t)
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return x[:, 0, :], caches


def decode_step(params: dict, token: torch.Tensor, caches: list, pos: int,
                cfg: ModelConfig):
    """One serving step: token (B, 1) at position ``pos``.

    Returns (logits (B, V), caches), the caches updated in place (see
    :func:`hidden_step`).
    """
    hidden, caches = hidden_step(params, token, caches, pos, cfg)
    return _head(params, hidden, cfg), caches


# ---------------------------------------------------------------------------
# Parameter accounting
# ---------------------------------------------------------------------------

def count_params(params) -> int:
    """Elements in a parameter tree (dicts and lists of tensors).  Built on
    the ``meta`` device (``init_params(cfg, device="meta")``), the tree
    holds shapes only, so a full config is counted without memory."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()


def active_params(cfg: ModelConfig, total: int) -> int:
    """Active parameters per token (MoE: only top-k experts count)."""
    if cfg.family != "moe":
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = cfg.num_layers // m.interleave_step
    inactive = per_expert * (m.num_experts - m.top_k) * n_moe_layers
    return total - inactive
