"""Decoder-LM assembly: pattern-grouped layers, train, prefill and decode.

The JAX package's ``models/transformer.py`` in PyTorch, for the layer
kinds

  dense       GQA attention + (SwiGLU | GELU) MLP
  moe         GQA attention + routed-experts FFN (``models.moe``)
  ssm         Mamba2 SSD block (``models.ssm``)
  rglru       RG-LRU recurrent block + MLP (``models.rglru``)
  local_attn  sliding-window GQA + MLP (recurrentgemma's attention layers)
  cross       encoder-decoder layer: causal self-attn + cross-attn + MLP
  mamba_moe   Mamba2 mixer + dropless experts and a shared expert
  attn_moe    GQA attention mixer + the same experts (Granite 4.0-H)

An architecture is a sequence of *block groups*, each a repeating
unit of layer kinds; per-group parameters and caches are stacked on a
leading ``repeats`` axis, and where the reference runs ``lax.scan`` over
that axis the port runs a Python loop.  Activations are pinned with
``launch.axes.constrain`` at the reference's sites: a no-op on plain
tensors, a DTensor redistribution inside a sharded cell
(``launch.steps.build_cell``).

A decode step marks its stages (``launch.graphs.mark``: the embedding,
each layer's mixer and FFN, the final norm), which a marked capture of it
times on the device; everywhere else the marks do nothing.

Full-sequence attention runs the flash kernel
(``kernels.ops.flash_attention``: its positions are ``arange(S)``, which
are the positions ``forward`` gives every layer), and the Mamba2 block
runs the SSD scan kernel; both wrappers are differentiable, so
:func:`forward_train` trains through them.  Decode stays plain PyTorch, as
in the JAX package, which has no kernel for it.

The encoder-decoder family (whisper-tiny) runs a non-causal encoder of
``dense`` layers over stub frame embeddings (``audio_embeds``) once per
forward; each ``cross`` layer attends to its own K/V projection of the
encoder output, non-causally, with q not roped (the reference ropes only
self-attention).  On that attention the kernel's row-index positions are
exact: nothing is masked, as the reference's all-zero encoder positions
mask nothing.  An encoder-decoder cache is the pair ``(caches,
enc_kvs)``.  The vision-language family (internvl2-1b) replaces the first
``num_image_tokens`` embeddings with stub patch embeddings
(``extra_embeds``).

A ``local_attn`` layer's cache is a ring of ``W`` (the window) slots:
position ``p`` lives in slot ``p % W`` and ``pos = -1`` marks an empty
slot.  Where the prompt length is a multiple of ``W`` this is the JAX
package's layout; where it is not, the reference keeps the last ``W``
keys in prompt order and decode overwrites a key still in the window
(ROADMAP R6), which the ring does not.

Attention logit softcaps raise ``NotImplementedError``: the flash kernel,
like the TPU kernel, has none, and no config sets one.

A config with ``layer_types`` (Granite 4.0-H, which the JAX package does
not have) is a hybrid whose every layer ends in the dropless expert layer
(``models.moe.dropless_moe``): ``mamba_moe`` and ``attn_moe`` layers,
grouped by runs of one mixer, each branch scaled by
``residual_multiplier`` into the residual, the embedding multiplied by
``embedding_multiplier`` and the logits divided by ``logits_scaling``.
Its attention may be NoPE (``AttentionConfig.rope`` False) and take its
own softmax scale: q is scaled by ``softmax_scale * sqrt(dh)`` before the
kernel's (and the decode's) ``1 / sqrt(dh)``.  In a decode step its
expert layer marks ``route`` and ``experts`` before the layer's ``ffn``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.axes import (constrain, einsum, local_like,
                                     local_shards, stack)
from repro_torch.launch.graphs import mark
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib

__all__ = [
    "block_groups", "init_params", "init_cache", "forward", "forward_train",
    "prefill", "decode_step", "hidden_step", "stub_extras", "count_params",
    "active_params",
]

# Static KV-cache quantization scale (int8 mode), as the reference's.
_KV_SCALE = 24.0


def _unsupported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run."""
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
    # a fill on the device, not a host copy (a CUDA graph captures it)
    return x.to(cfg.cdtype()) / torch.full((), _KV_SCALE, dtype=cfg.cdtype(),
                                           device=x.device)


# ---------------------------------------------------------------------------
# Architecture pattern
# ---------------------------------------------------------------------------

def block_groups(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(unit kinds, repeats)] covering cfg.num_layers exactly."""
    Lnum = cfg.num_layers
    if cfg.layer_types:
        # runs of consecutive layers of one mixer, each a group
        if len(cfg.layer_types) != Lnum:
            raise ValueError(f"{len(cfg.layer_types)} layer types for "
                             f"{Lnum} layers")
        kinds = {"mamba": "mamba_moe", "attention": "attn_moe"}
        groups: list = []
        for t in cfg.layer_types:
            if t not in kinds:
                raise ValueError(f"unknown layer type {t!r}")
            if groups and groups[-1][0] == (kinds[t],):
                groups[-1] = (groups[-1][0], groups[-1][1] + 1)
            else:
                groups.append(((kinds[t],), 1))
        return groups
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
    if kind in ("dense", "moe", "local_attn", "cross"):
        p["attn"] = _init_attn(gen, cfg, reps, dev)
        p["ln2"] = norm()
        p["ffn"] = (moe_lib.init_moe_params(gen, cfg.d_model, cfg.moe,
                                            cfg.pdtype(), reps, dev)
                    if kind == "moe" else _init_mlp(gen, cfg, reps, dev))
        if kind == "cross":
            p["xattn"] = _init_attn(gen, cfg, reps, dev)
            p["ln_x"] = norm()
    elif kind == "ssm":
        p["ssm"] = ssm_lib.init_ssm_params(gen, cfg.d_model, cfg.ssm,
                                           cfg.pdtype(), reps, dev)
    elif kind in ("mamba_moe", "attn_moe"):
        if kind == "mamba_moe":
            p["ssm"] = ssm_lib.init_ssm_params(gen, cfg.d_model, cfg.ssm,
                                               cfg.pdtype(), reps, dev)
        else:
            p["attn"] = _init_attn(gen, cfg, reps, dev)
        p["ln2"] = norm()
        p["ffn"] = moe_lib.init_moe_params(gen, cfg.d_model, cfg.moe,
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
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": _init_layer(gen, "dense", _encoder_cfg(cfg),
                                  (cfg.encoder_layers,), dev),
            "final_norm": L.init_norm(cfg.d_model, dt, cfg.norm, (), dev)}
    return params


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: the decoder's, with non-causal attention."""
    return dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, causal=False))


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on DTensors each rank looks its batch shard up in
    the whole table (``axes.local_shards``), whose gradient is then a
    partial sum over the batch axes."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    b = batch_axes(mesh)
    return local_shards(lambda t, i: t[i], mesh, (table, tokens),
                        ((), (b,)), ((*tokens.shape, table.shape[-1]), (b,)))


def _scale_q(q: torch.Tensor, a) -> torch.Tensor:
    """q scaled so that the attention's ``1 / sqrt(dh)`` gives the config's
    own softmax scale, where it sets one."""
    if a.softmax_scale is None:
        return q
    return q * (a.softmax_scale * math.sqrt(a.head_dim))


def _norm(cfg: ModelConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """The config's norm at its ``norm_eps`` (the norm's own default when
    unset)."""
    return L.apply_norm(cfg.norm, x, p, cfg.norm_eps)


def _attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, window=None, kv=None):
    """Projection + flash attention + output projection over a full
    sequence at ``positions = arange(S)``.  Returns (out, (k, v)).

    With ``kv`` (cross-attention: K/V precomputed from the encoder output)
    q is not roped and attends non-causally to those keys.
    """
    a = cfg.attention
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q = constrain(q, "batch", None, "tp", None)
    if kv is None:
        k = einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
        v = einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
        k = constrain(k, "batch", None, "tp", None)
        v = constrain(v, "batch", None, "tp", None)
        if a.rope:
            q = L.rope(q, positions, a.rope_theta)
            k = L.rope(k, positions, a.rope_theta)
        causal = a.causal
    else:
        k, v = kv
        causal = False
    out = ops.flash_attention(_scale_q(q, a), k, v, causal=causal,
                              window=window)
    out = einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    out = constrain(out, "batch", None, None)
    return out, (k, v)


def _ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
               kind: str) -> torch.Tensor:
    if kind == "moe":
        return moe_lib.moe_block(p, x, cfg.moe)
    if cfg.activation == "gelu":
        out = L.mlp_gelu(x, *(p[n].to(x.dtype) for n in ("w_fc", "b_fc",
                                                         "w_proj", "b_proj")))
    else:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
        h = constrain(h, "batch", None, "tp")
        out = h @ p["w_down"].to(x.dtype)
    return constrain(out, "batch", None, None)


def _layer_fwd(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, enc_kv=None):
    """Full-sequence layer forward.  Returns (x, cache_entry).

    A ``cross`` layer takes its precomputed encoder K/V as ``enc_kv``.
    """
    norm = lambda n, h: _norm(cfg, h, n)
    if kind in ("mamba_moe", "attn_moe"):
        r = cfg.residual_multiplier
        if kind == "mamba_moe":
            h, cache = ssm_lib.ssm_block(p["ssm"], norm(p["ln1"], x),
                                         cfg.d_model, cfg.ssm,
                                         eps=_ssm_eps(cfg))
            # the conv windows are views of the whole prompt's streams:
            # copied, they no longer hold those (Granite: 0.5 GB a layer
            # at 32 x 1024 tokens) until the group's caches are stacked
            cache = {n: t.clone() if n.startswith("conv") else t
                     for n, t in cache.items()}
        else:
            h, (k, v) = _attn_apply(p["attn"], norm(p["ln1"], x), cfg,
                                    positions, window=cfg.attention.window)
            cache = {"k": k, "v": v}
        x = x + h * r
        x = x + moe_lib.moe_block(p["ffn"], norm(p["ln2"], x), cfg.moe) * r
        return x, cache
    if kind in ("dense", "moe", "local_attn", "cross"):
        window = (_local_window(cfg) if kind == "local_attn"
                  else cfg.attention.window)
        h, (k, v) = _attn_apply(p["attn"], norm(p["ln1"], x), cfg,
                                positions, window=window)
        x = x + h
        if kind == "cross":
            h, _ = _attn_apply(p["xattn"], norm(p["ln_x"], x), cfg,
                               positions, window=cfg.attention.window,
                               kv=enc_kv)
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


def _ssm_eps(cfg: ModelConfig) -> float:
    """The epsilon of a Mamba2 mixer's gated norm."""
    return 1e-6 if cfg.norm_eps is None else cfg.norm_eps


def _local_window(cfg: ModelConfig) -> int:
    return cfg.rglru.window if cfg.rglru else cfg.attention.window


def _ring(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
          W: int) -> dict:
    """A local-attention cache of ``W`` slots holding the last ``W`` keys
    and values of a prompt (positions ``[max(0, S - W), S)``), position
    ``p`` in slot ``p % W``; the other slots empty (``pos = -1``).  On
    DTensors each rank fills its batch shard's ring
    (``axes.local_shards``)."""
    if isinstance(k, DTensor):
        mesh = k.device_mesh
        b = batch_axes(mesh)
        spec = (b, None, "model")
        ring = (*k.shape[:1], W, *k.shape[2:])
        if not isinstance(positions, DTensor):     # the same on every rank
            positions = DTensor.from_local(
                positions, mesh, [Replicate()] * mesh.ndim, run_check=False)
        kc, vc, pc = local_shards(
            lambda *a: tuple(_ring(*a, W).values()), mesh,
            (k, v, positions), (spec, spec, (b,)),
            [(ring, spec), (ring, spec), (ring[:2], (b,))])
        return {"k": kc, "v": vc, "pos": pc}
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


def _cross_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  pos_b: torch.Tensor, enc_kv) -> torch.Tensor:
    """One token's cross-attention to the encoder K/V, in plain PyTorch
    (``layers.attention``) at the reference's positions: the query at
    ``pos``, the encoder keys all at 0, non-causal; q not roped."""
    ek, ev = enc_kv
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    acfg = dataclasses.replace(cfg.attention, causal=False)
    enc_pos = torch.zeros(ek.shape[:2], dtype=torch.int64, device=x.device)
    out = L.attention(q, ek, ev, pos_b[:, None], enc_pos, acfg)
    return einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def _write_slot(cache: torch.Tensor, index,
                value: torch.Tensor) -> None:
    """``cache[:, index:index + n] = value`` in place (n = value's dim 1).

    ``index`` is an int or a 0-d int64 tensor on the cache's device (a
    traced position: the write reads the slot on the device, so a CUDA
    graph replays it at every step).  A plain cache raises ``IndexError``
    for slots past its end, at an int as at a tensor (where on the card it
    is a device-side assert).

    A DTensor cache may be split along dim 1 (a context-parallel KV cache);
    DTensor would gather such a dim to slice it and write into the copy,
    so each rank writes the slots it holds into its own shard instead
    (:func:`_write_local`), at an int or at a tensor position alike.
    """
    n = value.shape[1]
    if not isinstance(cache, DTensor):
        if isinstance(index, torch.Tensor):
            slots = index + torch.arange(n, dtype=torch.int64,
                                         device=cache.device)
            cache.index_copy_(1, slots, value.to(cache.dtype))
            return
        if index + n > cache.shape[1]:     # as index_copy_ at a tensor index
            raise IndexError(f"slots {index}..{index + n - 1} are out of "
                             f"bounds for a cache of {cache.shape[1]}")
        cache[:, index:index + n] = value
        return
    mesh, pl = cache.device_mesh, cache.placements
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    value = value.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                      for p in pl]).to_local()
    local = cache.to_local()
    shard, coordinate = 0, mesh.get_coordinate()
    for dim, p in enumerate(pl):
        if p.is_shard(1):
            shard = shard * mesh.size(dim) + coordinate[dim]
    lo = shard * local.shape[1]
    if isinstance(index, torch.Tensor):
        if isinstance(index, DTensor):     # a position, the same on every rank
            index = index.to_local()
        _write_local(local, index - lo, value)
        return
    first, last = max(index, lo), min(index + n, lo + local.shape[1])
    if first < last:
        local[:, first - lo:last - lo] = value[:, first - index:last - index]


def _write_local(local: torch.Tensor, start: torch.Tensor,
                 value: torch.Tensor) -> None:
    """``local[:, start:start + n] = value`` for the slots that lie in
    ``local`` (``start`` a 0-d device tensor, maybe negative or past the
    end), with static shapes and no host read: the slots ``start + i``
    of each run of at most ``S = local.shape[1]`` consecutive ones are
    distinct mod S, so ``index_copy_`` at ``(start + i) mod S`` writes each
    slot once, the value where it lies in the shard and the slot's own
    entry back where it does not."""
    S = local.shape[1]
    bcast = (1, -1) + (1,) * (local.ndim - 2)
    for c0 in range(0, value.shape[1], S):
        v = value[:, c0:c0 + S].to(local.dtype)
        k = start + c0 + torch.arange(v.shape[1], dtype=torch.int64,
                                      device=local.device)
        slots = torch.remainder(k, S)
        inside = ((k >= 0) & (k < S)).view(bcast)
        local.index_copy_(1, slots, torch.where(
            inside, v, local.index_select(1, slots)))


def _qkv_decode(ap: dict, hin: torch.Tensor, a,
                pos_b: torch.Tensor) -> tuple:
    """One token's q, k and v (B, 1, heads, dh), roped at ``pos_b`` where
    the config ropes."""
    q = einsum("bsd,dhk->bshk", hin, ap["wq"].to(hin.dtype))
    k = einsum("bsd,dhk->bshk", hin, ap["wk"].to(hin.dtype))
    v = einsum("bsd,dhk->bshk", hin, ap["wv"].to(hin.dtype))
    if a.rope:
        q = L.rope(q, pos_b[:, None], a.rope_theta)
        k = L.rope(k, pos_b[:, None], a.rope_theta)
    return q, k, v


def _attn_decode(ap: dict, hin: torch.Tensor, cache: dict, cfg: ModelConfig,
                 pos, pos_b: torch.Tensor) -> torch.Tensor:
    """Attention of one token (B, 1, D) against a cache of every position,
    written in place at slot ``pos``, at the config's softmax scale; the
    output projection's result."""
    a = cfg.attention
    q, k, v = _qkv_decode(ap, hin, a, pos_b)
    _write_slot(cache["k"], pos, _quant_kv(k, cfg))
    _write_slot(cache["v"], pos, _quant_kv(v, cfg))
    out = L.decode_attention(_scale_q(q, a), _dequant_kv(cache["k"], cfg),
                             _dequant_kv(cache["v"], cfg), pos_b, a,
                             cache_len=pos_b + 1)
    return einsum("bshk,hkd->bsd", out, ap["wo"].to(hin.dtype))


def _layer_decode(kind: str, p: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig, pos, enc_kv=None):
    """Single-token layer step against a cache.  Returns (x, new_cache).

    The attention KV cache is written in place at slot ``pos`` (the
    reference's ``dynamic_update_slice``); the returned cache holds the
    same tensors.  A ``cross`` layer takes its encoder K/V as ``enc_kv``.
    ``pos`` is an int or a 0-d int64 tensor on x's device (see
    :func:`hidden_step`).
    """
    norm = lambda n, h: _norm(cfg, h, n)
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_b = pos.expand(B)
    else:
        pos_b = torch.full((B,), pos, dtype=torch.int64, device=x.device)
    if kind in ("mamba_moe", "attn_moe"):
        r = cfg.residual_multiplier
        hin = norm(p["ln1"], x)
        if kind == "mamba_moe":
            h, new_cache = ssm_lib.ssm_decode_step(
                p["ssm"], hin, cache, cfg.d_model, cfg.ssm, eps=_ssm_eps(cfg))
        else:
            h, new_cache = _attn_decode(p["attn"], hin, cache, cfg, pos,
                                        pos_b), cache
        x = x + h * r
        mark("mixer")
        x = x + moe_lib.moe_block(p["ffn"], norm(p["ln2"], x), cfg.moe) * r
        mark("ffn")
        return x, new_cache
    if kind in ("dense", "moe", "local_attn", "cross"):
        a = cfg.attention
        hin = norm(p["ln1"], x)
        ap = p["attn"]
        if kind == "local_attn":
            q, k, v = _qkv_decode(ap, hin, a, pos_b)
            # the ring: position pos in slot pos % W; a slot is valid while
            # its position is inside the window ending at pos, and an empty
            # slot (pos -1) never is
            W = _local_window(cfg)
            slot = pos % W
            _write_slot(cache["k"], slot, _quant_kv(k, cfg))
            _write_slot(cache["v"], slot, _quant_kv(v, cfg))
            _write_slot(cache["pos"], slot,
                        pos_b[:, None].to(torch.int32))
            pc = cache["pos"]
            valid = (pc >= 0) & (pc <= pos) & (pc > pos - W)
            bias = torch.where(valid, 0.0, L._NEG_INF)
            qg = L.group_heads(_scale_q(q, a), a.num_kv_heads)
            out = L._attend(qg, _dequant_kv(cache["k"], cfg),
                            _dequant_kv(cache["v"], cfg),
                            bias[:, None, None, None, :],
                            a.attn_logit_softcap)
            out = out.reshape(B, 1, a.num_heads, a.head_dim)
            h = einsum("bshk,hkd->bsd", out, ap["wo"].to(x.dtype))
        else:
            h = _attn_decode(ap, hin, cache, cfg, pos, pos_b)
        x = x + h
        mark("mixer")
        if kind == "cross":
            x = x + _cross_decode(p["xattn"], norm(p["ln_x"], x), cfg,
                                  pos_b, enc_kv)
            mark("mixer")
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, kind)
        mark("ffn")
        return x, cache
    if kind == "ssm":
        h, new_cache = ssm_lib.ssm_decode_step(p["ssm"], norm(p["ln1"], x),
                                               cache, cfg.d_model, cfg.ssm)
        x = x + h
        mark("mixer")
        return x, new_cache
    if kind == "rglru":
        h, new_cache = rglru_lib.rglru_decode_step(
            p["rglru"], norm(p["ln1"], x), cache, cfg.rglru)
        x = x + h
        mark("mixer")
        x = x + _ffn_apply(p["ffn"], norm(p["ln2"], x), cfg, "dense")
        mark("ffn")
        return x, new_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> list:
    """Stacked zero caches aligned with params['groups'] (an
    encoder-decoder's decoder caches only: its encoder K/V come from
    :func:`prefill`)."""
    _unsupported(cfg)
    dev = resolve_device(device)
    a = cfg.attention
    dt = cfg.cdtype()
    kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dt
    groups = []
    for unit, reps in block_groups(cfg):
        unit_caches = []
        for kind in unit:
            if kind in ("ssm", "mamba_moe"):
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

def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  extra_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    x = _lookup(params["embed"], tokens).to(cfg.cdtype())
    if cfg.embedding_multiplier is not None:
        x = x * torch.full((), cfg.embedding_multiplier, dtype=x.dtype,
                           device=x.device)
    elif cfg.family == "hybrid":  # gemma-style embedding scale
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    if cfg.num_image_tokens and extra_embeds is not None:
        n = cfg.num_image_tokens
        x = torch.cat([extra_embeds.to(x.dtype), x[:, n:]], dim=1)
    return constrain(x, "batch", None, None)


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The plain, full-precision LM head on normed hidden states."""
    w = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
         else params["lm_head"].to(x.dtype))
    logits = x @ w
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return constrain(logits, "batch", None, "tp")


def _unstack(group_params: dict) -> list:
    """A group's stacked parameters as one dict of views per layer.

    ``torch.unbind``: under autograd its backward stacks the layers'
    gradients once, where taking layer ``r`` by indexing would fill and
    add a full-size gradient of the stack for every layer.
    """
    per_name = {n: (_unstack(v) if isinstance(v, dict) else torch.unbind(v))
                for n, v in group_params.items()}
    reps = len(next(iter(per_name.values())))
    return [{n: v[r] for n, v in per_name.items()} for r in range(reps)]


def _run_layer(remat: bool, kind: str, p: dict, x: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor, enc_kv=None):
    """One layer's forward; with ``remat`` under grad, its activations
    are recomputed in backward (``torch.utils.checkpoint``, the
    reference's ``_remat``) and no cache is kept.  The forward draws no
    random numbers, so the recompute keeps no RNG state (saving the
    card's RNG state is refused inside a CUDA graph capture)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(lambda h: _layer_fwd(kind, p, h, cfg, positions,
                                               enc_kv)[0],
                          x, use_reentrant=False,
                          preserve_rng_state=False), None
    return _layer_fwd(kind, p, x, cfg, positions, enc_kv)


def _encoder_fwd(params: dict, audio_embeds: torch.Tensor, cfg: ModelConfig,
                 remat: bool = False) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, S_enc, D)."""
    if audio_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         f"audio_embeds (B, {cfg.encoder_seq}, "
                         f"{cfg.d_model})")
    x = audio_embeds.to(cfg.cdtype())
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int64, device=x.device).expand(B, S)
    ecfg = _encoder_cfg(cfg)
    enc = params["encoder"]
    for p in _unstack(enc["layers"]):
        x, _ = _run_layer(remat, "dense", p, x, ecfg, pos)
    return _norm(cfg, x, enc["final_norm"])


def _enc_cross_kv(params: dict, enc_out: torch.Tensor,
                  cfg: ModelConfig) -> list:
    """Per decoder group and unit: the cross-attention K/V of the encoder
    output, stacked over the group's repeats ``(reps, B, S_enc, n_kv,
    dh)``."""
    kvs = []
    for unit_params in params["groups"]:
        for p in unit_params:
            xp = p["xattn"]
            kvs.append(tuple(
                einsum("bsd,rdhk->rbshk", enc_out, xp[w].to(enc_out.dtype))
                for w in ("wk", "wv")))
    return kvs


def _forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
             extra_embeds=None, audio_embeds=None, want_cache: bool = False,
             remat: bool = False, last_only: bool = False):
    """(logits, caches or None, encoder K/V or None): the encoder runs
    once, and :func:`prefill` keeps its K/V for decode.  With
    ``last_only`` the head runs at the last position alone."""
    _unsupported(cfg)
    B, S = tokens.shape
    x = _embed_inputs(params, tokens, cfg, extra_embeds)
    positions = torch.arange(S, dtype=torch.int64,
                             device=x.device).expand(B, S)
    enc_kvs = None
    if cfg.is_encdec:
        enc_kvs = _enc_cross_kv(
            params, _encoder_fwd(params, audio_embeds, cfg, remat), cfg)
    caches = []
    for g, (unit, reps) in enumerate(block_groups(cfg)):
        per_layer = [[] for _ in unit]
        layers = [_unstack(p) for p in params["groups"][g]]
        cross = [tuple(zip(*map(torch.unbind, enc_kvs[g * len(unit) + u])))
                 if kind == "cross" else None
                 for u, kind in enumerate(unit)]
        for r in range(reps):
            for u, kind in enumerate(unit):
                enc_kv = cross[u][r] if cross[u] else None
                x, c = _run_layer(remat, kind, layers[u][r], x, cfg,
                                  positions, enc_kv)
                if want_cache:
                    per_layer[u].append(c)
        if want_cache:
            caches.append([{n: stack([c[n] for c in cs])
                            for n in cs[0]} for cs in per_layer])
    if last_only:
        x = x[:, -1:]
    logits = _head(params, _norm(cfg, x, params["final_norm"]), cfg)
    return logits, (caches if want_cache else None), enc_kvs


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            extra_embeds: Optional[torch.Tensor] = None,
            audio_embeds: Optional[torch.Tensor] = None,
            want_cache: bool = False):
    """Full-sequence forward.  Returns (logits, cache-or-None).

    ``extra_embeds`` (B, num_image_tokens, D) replace the first embeddings
    of a vlm config; ``audio_embeds`` (B, encoder_seq, D) feed an
    encoder-decoder's encoder.
    """
    logits, caches, _ = _forward(params, tokens, cfg,
                                 extra_embeds=extra_embeds,
                                 audio_embeds=audio_embeds,
                                 want_cache=want_cache)
    return logits, caches


def forward_train(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                  cfg: ModelConfig, *, loss_mask=None, extra_embeds=None,
                  audio_embeds=None):
    """Token-mean cross-entropy (fp32 logsumexp).  Returns (loss,
    metrics).

    A vlm config's image positions carry no loss unless ``loss_mask``
    says otherwise.  With ``cfg.remat_policy`` other than ``"none"`` every
    layer is recomputed in backward (``torch.utils.checkpoint``, in place
    of the reference's ``jax.checkpoint`` policies).
    """
    from repro_torch.models.loss import cross_entropy
    logits, _, _ = _forward(params, tokens, cfg, extra_embeds=extra_embeds,
                            audio_embeds=audio_embeds,
                            remat=cfg.remat_policy != "none")
    if loss_mask is None and cfg.num_image_tokens:
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None, :]
        loss_mask = (pos >= cfg.num_image_tokens).expand(B, S)
    return cross_entropy(logits, targets, loss_mask)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, *, extra_embeds=None, audio_embeds=None):
    """Run the prompt; returns (last-position logits, caches @ max_len).

    An encoder-decoder's caches are the pair ``(caches, enc_kvs)``.  A
    config with ``layer_types`` runs the head at the last position only
    (Granite's 100k-entry head over a whole batch of prompts would hold
    6.6 GB of logits at 32 x 1024 tokens).
    """
    logits, caches, enc_kvs = _forward(
        params, tokens, cfg, extra_embeds=extra_embeds,
        audio_embeds=audio_embeds, want_cache=True,
        last_only=bool(cfg.layer_types))
    S = tokens.shape[1]
    padded = []
    for g, (unit, _) in enumerate(block_groups(cfg)):
        unit_caches = []
        for u, kind in enumerate(unit):
            c = caches[g][u]
            if kind in ("dense", "moe", "cross", "attn_moe"):
                # (reps, B, S, n_kv, dh) -> (reps, B, max_len, n_kv, dh);
                # on a mesh each rank pads its shard, the sequence whole
                pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, max_len - S))
                c = {n: local_like(pad, _quant_kv(c[n], cfg),
                                   c[n].shape[:2] + (max_len,)
                                   + c[n].shape[3:], whole=(2,))
                     for n in ("k", "v")}
            elif kind == "local_attn":
                c = dict(c, k=_quant_kv(c["k"], cfg),
                         v=_quant_kv(c["v"], cfg))
            unit_caches.append(c)
        padded.append(unit_caches)
    if cfg.is_encdec:
        return logits[:, -1, :], (padded, enc_kvs)
    return logits[:, -1, :], padded


def hidden_step(params: dict, token: torch.Tensor, caches, pos,
                cfg: ModelConfig, *, enc_kvs=None):
    """One decode step up to the final norm: token (B, 1) at position
    ``pos``.  Returns (normed hidden (B, D), caches).

    ``pos`` is an int, or a 0-d int64 tensor on the caches' device: then
    every position-dependent step (rope, the cache slot, the ring's slot
    and mask) is device arithmetic, nothing reads it on the host, and one
    captured CUDA graph serves every position (the reference traces
    ``pos`` under ``jax.jit``).  So on a mesh too, where ``pos`` may be a
    replicated 0-d DTensor: each rank writes the slots its cache shards
    hold (:func:`_write_slot`), a context-parallel split of the cache
    among them, and nothing is gathered.

    Caches are updated in place: the stacked tensors of ``caches`` hold the
    new entries when this returns (the reference donates them instead).
    An encoder-decoder's ``caches`` are the pair ``(caches, enc_kvs)``
    unless ``enc_kvs`` is passed apart; they are returned as given.
    """
    _unsupported(cfg)
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64:
            raise TypeError(f"a tensor position is a 0-d int64 tensor, got "
                            f"{pos.dtype} of shape {tuple(pos.shape)}")
    else:
        pos = int(pos)
    given = caches
    if cfg.is_encdec and enc_kvs is None:
        caches, enc_kvs = caches
    x = _embed_inputs(params, token, cfg)
    mark("embed")
    for g, (unit, reps) in enumerate(block_groups(cfg)):
        layers = [_unstack(p) for p in params["groups"][g]]
        for r in range(reps):
            for u, kind in enumerate(unit):
                stacked = caches[g][u]
                layer_cache = {n: t[r] for n, t in stacked.items()}
                enc_kv = None
                if kind == "cross":
                    ek, ev = enc_kvs[g * len(unit) + u]
                    enc_kv = (ek[r], ev[r])
                x, new = _layer_decode(kind, layers[u][r], x, layer_cache,
                                       cfg, pos, enc_kv)
                for n, t in new.items():
                    if t is not layer_cache[n]:
                        stacked[n][r].copy_(t)
    x = _norm(cfg, x, params["final_norm"])
    mark("norm")
    return x[:, 0, :], given


def decode_step(params: dict, token: torch.Tensor, caches, pos,
                cfg: ModelConfig, *, enc_kvs=None):
    """One serving step: token (B, 1) at position ``pos`` (an int or a
    0-d int64 tensor, as :func:`hidden_step`).

    Returns (logits (B, V), caches), the caches updated in place (see
    :func:`hidden_step`).
    """
    hidden, caches = hidden_step(params, token, caches, pos, cfg,
                                 enc_kvs=enc_kvs)
    return _head(params, hidden, cfg), caches


def stub_extras(cfg: ModelConfig, batch: int,
                device: str | torch.device = "cuda",
                seed: Optional[int] = None) -> dict:
    """The frontends' stub inputs: patch embeddings (batch,
    num_image_tokens, D) for a vlm config, frame embeddings (batch,
    encoder_seq, D) for an encoder-decoder.

    Zeros, as the reference's drivers give them, unless ``seed`` is given:
    then standard normal draws from a ``torch.Generator`` on ``device``
    seeded with it.  Training needs the draws (ROADMAP R7): on zero patch
    embeddings internvl2-1b's image positions stay exactly zero through
    every layer, each RMS norm's backward there multiplies the gradient by
    ``rsqrt(eps) = 1000``, and at 24 layers it overflows.
    """
    dev = resolve_device(device)
    gen = (None if seed is None
           else torch.Generator(device=dev).manual_seed(seed))

    def stub(*shape):
        if gen is None:
            return torch.zeros(shape, dtype=cfg.cdtype(), device=dev)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).to(cfg.cdtype())

    extras = {}
    if cfg.num_image_tokens:
        extras["extra_embeds"] = stub(batch, cfg.num_image_tokens,
                                      cfg.d_model)
    if cfg.is_encdec:
        extras["audio_embeds"] = stub(batch, cfg.encoder_seq, cfg.d_model)
    return extras


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
