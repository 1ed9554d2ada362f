"""Mixture-of-Experts blocks: top-k router + GShard-style grouped dispatch,
and a dropless dispatch grouped by expert.

The JAX package's ``models/moe.py`` in PyTorch, with the same dispatch:
tokens are split into groups of ``group_size``; each group dispatches
into per-expert capacity buffers ``C = ceil(group_size / E * k *
capacity_factor)`` (at least 2) through one-hot ``(G, Tg, E, C)``
dispatch and combine tensors and einsums.  Tokens over a group's capacity
are dropped (they pass through the residual).  A shared expert
(Qwen2-MoE: 4x1408 fused; Llama4: one 8192) runs densely alongside the
routed experts.  The reference has no kernel here, and neither has the
port.

The router's top-k breaks ties towards the lower expert index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order among ties).

A config with ``dropless`` (Granite 4.0-H) takes :func:`dropless_moe`
instead, which the JAX package has no counterpart of: no capacity, no
token dropped, and the expert layer of expert parallelism.  The router
picks over all ``router_width`` experts; the layer holds the
``num_experts`` from ``first_expert`` on and computes only their part of
the result, for the (token, pick) pairs routed to them, plus the shared
expert.  The pairs are ordered by expert on the device, their rows
gathered, the expert SwiGLUs run as two grouped products over row counts
that only the device knows (``kernels.ops.moe_grouped_gemm``: a kernel on
the card), and the gate-weighted rows added back.  Inside a CUDA graph's
capture (the decode step) nothing reads the device on the host: the
buffers are sized for every pair.  Anywhere else (a prefill, an eager
step) they are sized for the held pairs, after one read of their count.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.launch import graphs
from repro_torch.launch.axes import constrain, einsum
from repro_torch.models.layers import init_linear, mlp_swiglu

__all__ = ["DISPATCH_GROUP", "DROPLESS_TOKENS",
           "init_moe_params", "lossless_capacity", "moe_block",
           "dropless_moe", "route_held", "router_topk"]

DISPATCH_GROUP = 4096  # tokens per dispatch group (GShard's G)

#: tokens a dropless call dispatches at once (a prefill's are split, which
#: bounds the gathered rows' memory; each part reads the experts again)
DROPLESS_TOKENS = 16384


def init_moe_params(gen: torch.Generator | None, d_model: int,
                    cfg: MoEConfig, dtype: torch.dtype,
                    extra_dims: tuple[int, ...] = (),
                    device: torch.device | str = "cuda") -> dict:
    """Router, experts stacked on an E axis (``we_*``) and the shared
    expert, on ``device`` (the card unless the caller asks for the CPU;
    ``gen`` must live there too)."""
    device = resolve_device(device)
    E, Fd = cfg.num_experts, cfg.d_ff_expert
    lin = lambda a, b, extra=(): init_linear(gen, a, b, dtype,
                                             extra_dims + extra, device)
    params = {
        "router": lin(d_model, cfg.router_width),
        "we_gate": lin(d_model, Fd, (E,)),
        "we_up": lin(d_model, Fd, (E,)),
        "we_down": lin(Fd, d_model, (E,)),
    }
    if cfg.d_ff_shared:
        params["shared"] = {"w_gate": lin(d_model, cfg.d_ff_shared),
                            "w_up": lin(d_model, cfg.d_ff_shared),
                            "w_down": lin(cfg.d_ff_shared, d_model)}
    return params


def router_topk(logits: torch.Tensor, k: int):
    """Top-k gates (renormalised over the k picks) + expert indices.

    logits: (..., E) -> gates (..., k) float32, idx (..., k) int64.  A
    stable descending sort keeps tied experts in index order, so ties go
    to the lower index as in ``jax.lax.top_k``.
    """
    gates_full = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.sort(gates_full, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def _expert_ffn(expert_in, wg, wu, wd):
    """Each expert's SwiGLU on its capacity buffer: (G, E, C, D) in and
    out, weights stacked on E."""
    h = (F.silu(einsum("gecd,edf->gecf", expert_in, wg))
         * einsum("gecd,edf->gecf", expert_in, wu))
    return einsum("gecf,efd->gecd", h, wd)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as a comparison: the same int64 values, with
    no range check (``one_hot`` reads the indices' min and max on the host
    for a CPU tensor, which a CUDA graph's capture path must not do)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int64)


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig,
              group_size: int | None = None) -> torch.Tensor:
    """Apply the routed-expert FFN to x (..., D); returns the same shape
    (:func:`dropless_moe` for a dropless config)."""
    if cfg.dropless:
        return dropless_moe(params, x, cfg)
    orig_shape = x.shape
    D = x.shape[-1]
    xf = x.reshape(-1, D)                          # (T, D)
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.top_k

    if group_size is None:
        group_size = cfg.dispatch_group or DISPATCH_GROUP
    Tg = min(group_size, T)
    if T % Tg:
        Tg = math.gcd(T, Tg)
    G = T // Tg
    capacity = max(int(math.ceil(Tg / E * k * cfg.capacity_factor)), 2)

    dtype = x.dtype
    xg = xf.reshape(G, Tg, D)
    router_logits = xg @ params["router"].to(dtype)
    gates, idx = router_topk(router_logits, k)     # (G, Tg, k)

    # Position of each (token, choice) inside its expert's group buffer:
    # a running count over the group's (token, choice) pairs per expert,
    # taken along the innermost dim (a scan along an outer dim of a CUDA
    # tensor runs one thread per column)
    flat = _one_hot(idx, E).to(torch.int32).reshape(G, Tg * k, E)
    # dim=2, not -1: DTensor scans a sharded dim named from the end
    # shard by shard (torch 2.13)
    pos = torch.cumsum(flat.transpose(1, 2), dim=2).transpose(1, 2) - 1
    pos = (pos * flat).sum(-1).reshape(G, Tg, k)
    keep = pos < capacity
    gates = torch.where(keep, gates, 0.0)
    # index == capacity one-hots to all zeros, so dropped tokens vanish
    pos = torch.where(keep, pos, capacity)

    # Accumulate over the k choices one at a time so only the
    # (G, Tg, E, C) dispatch/combine pair is live.
    dispatch = combine = None
    for kk in range(k):
        oh = (_one_hot(idx[..., kk], E).to(dtype)[..., None]
              * _one_hot(pos[..., kk], capacity + 1)[..., :capacity]
              .to(dtype)[..., None, :])            # (G, Tg, E, C)
        weighted = oh * gates[..., kk, None, None].to(dtype)
        dispatch = oh if dispatch is None else dispatch + oh
        combine = weighted if combine is None else combine + weighted
        del oh, weighted

    dispatch = constrain(dispatch, "batch", None, "tp", None)
    combine = constrain(combine, "batch", None, "tp", None)
    expert_in = einsum("gtd,gtec->gecd", xg, dispatch)  # (G,E,C,D)
    expert_in = constrain(expert_in, "batch", "tp", None, None)
    wg, wu, wd = (params[n].to(dtype) for n in ("we_gate", "we_up",
                                                "we_down"))
    expert_out = constrain(_expert_ffn(expert_in, wg, wu, wd),
                           "batch", "tp", None, None)
    yg = einsum("gecd,gtec->gtd", expert_out, combine)  # (G, Tg, D)
    yg = constrain(yg, "batch", None, None)

    yf = yg.reshape(T, D)
    if cfg.d_ff_shared:
        sp = params["shared"]
        yf = yf + mlp_swiglu(xf, sp["w_gate"].to(dtype),
                             sp["w_up"].to(dtype), sp["w_down"].to(dtype))
        # the tokens over the batch axes only: DTensor may reduce-scatter
        # the shared expert's sum over the tokens on ``model`` too, and
        # cannot split such a dim back into (batch, sequence)
        yf = constrain(yf, "batch", None)
    return yf.reshape(orig_shape)


def route_held(xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
               static: bool):
    """The held pairs of tokens ``xf (T, D)``, ordered by expert.

    Router logits in float32 over all ``router_width`` experts, the top
    ``k`` (:func:`router_topk`: a softmax over all the logits renormalised
    over the picks, which equals Granite's softmax over the k picked
    logits), then the (token, pick) pairs whose expert is held, ordered by
    held expert with their counts and offsets on the device.  With
    ``static`` every pair has a row, those of experts not held last;
    otherwise the held ones only (their count read on the host).

    Returns ``(tok, gate, offsets, counts)``: the token (int64) and gate
    (float32) of each row, ``offsets (E + 1,)`` int32 (expert ``e``'s rows
    are ``offsets[e]:offsets[e + 1]``) and ``counts (E,)`` int32.
    """
    E, k = cfg.num_experts, cfg.top_k
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    gates, idx = router_topk(logits, k)                     # (T, k)
    local = idx.reshape(-1) - cfg.first_expert
    held = (local >= 0) & (local < E)
    key = torch.where(held, local, E)                       # E: not held
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(E + 1, dtype=torch.int32, device=xf.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    counts = counts[:E]
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    if not static:
        order = order[:int(offsets[E])]
    tok = torch.div(order, k, rounding_mode="floor")
    gate = gates.reshape(-1).index_select(0, order)
    return tok, gate, offsets, counts


def dropless_moe(params: dict, x: torch.Tensor,
                 cfg: MoEConfig) -> torch.Tensor:
    """The dropless expert layer on x (..., D): the held experts' part of
    the routed result, plus the shared expert (see the module docstring).

    In a decode step the stages are marked (``launch.graphs.mark``):
    ``route`` (router, top-k, ordering and gathering of the held pairs),
    ``experts`` (the grouped products and the activation between them);
    the caller marks what follows.  A marked capture also counts, for
    :data:`launch.graphs.counter_log`, the held experts with a pair and
    the pairs they got (``moe.route``)."""
    orig_shape = x.shape
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    if T > DROPLESS_TOKENS:
        return torch.cat([dropless_moe(params, part, cfg)
                          for part in xf.split(DROPLESS_TOKENS)]
                         ).reshape(orig_shape)
    # a CUDA graph's capture cannot read the device on the host: there
    # every pair gets a row; anywhere else the held pairs alone
    static = xf.is_cuda and torch.cuda.is_current_stream_capturing()
    tok, gate, offsets, counts = route_held(xf, params["router"], cfg,
                                            static)
    if graphs.counting():
        graphs.count("moe.route", torch.stack([(counts > 0).sum(),
                                               counts.sum()]))
    dtype = x.dtype
    rows = xf.index_select(0, tok)
    graphs.mark("route")
    h = ops.moe_grouped_gemm(rows, params["we_gate"].to(dtype), offsets,
                             w_up=params["we_up"].to(dtype))
    y = ops.moe_grouped_gemm(h, params["we_down"].to(dtype), offsets)
    graphs.mark("experts")
    # rows of no held expert are zero (their gates times nothing)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, y * gate[:, None])      # in float32
    out = out.to(dtype)
    if cfg.d_ff_shared:
        sp = params["shared"]
        out = out + mlp_swiglu(xf, sp["w_gate"].to(dtype),
                               sp["w_up"].to(dtype), sp["w_down"].to(dtype))
    return out.reshape(orig_shape)


def lossless_capacity(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with a capacity factor of E / k, at which no group can
    overflow an expert, so prefill, decode and forward (whose dispatch
    groups differ) drop nothing; the JAX package's decode-vs-forward test
    does the same.  A config without experts is returned as it is."""
    if cfg.moe is None:
        return cfg
    cf = cfg.moe.num_experts / cfg.moe.top_k
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
