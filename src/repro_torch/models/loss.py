"""Token-mean cross-entropy and top-1 accuracy, in fp32.

The JAX package's ``models/loss.py`` in PyTorch: the logits are taken to
fp32 before the logsumexp, and a mask (B, S) selects the positions that
count (a vlm config's text positions, padding), its denominator clamped
at 1.  Inside a sharded cell the logits arrive as a DTensor with the
vocab over ``model``; each rank takes the logsumexp of its own vocab
shard (the shards' are combined by one more logsumexp) and picks the
target's logit out of its shard (zero where the target lies in
another's: a partial sum with one nonzero term, so exactly the gathered
value).  The token sum is each rank's sum of its own shard
(:func:`_total`), so that backward hands every rank the gradient of its
own tokens.  No rank holds the logits of the whole vocab.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["cross_entropy", "top1_accuracy"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """Token-mean CE.  logits (B, S, V) any float dtype; targets (B, S) int.

    Returns (loss, metrics) with fp32 math; metrics are ``loss`` and
    ``ntokens``, the denominator.
    """
    logits = logits.to(torch.float32)
    if isinstance(logits, DTensor):
        lse, true_logit = _sharded_terms(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)                  # (B, S)
        true_logit = torch.gather(logits, -1,
                                  targets[..., None].to(torch.int64))[..., 0]
    nll = lse - true_logit                                     # (B, S)
    if mask is None:
        # a fill on the device, not a copy from host memory (which a CUDA
        # graph capture refuses)
        denom = torch.full((), float(nll.numel()), dtype=torch.float32,
                           device=nll.device)
        loss = _total(nll) / denom
    else:
        m = mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        loss = _total(nll * m) / denom
    return loss, {"loss": loss, "ntokens": denom}


def _sharded_terms(logits: DTensor, targets: torch.Tensor):
    """(logsumexp, target's logit), (B, S) each, laid out as the logits'
    batch dims, with every rank reading only its own shard of the vocab:
    each rank takes the logsumexp of its shard (one per shard, combined by
    a logsumexp over the shards) and picks the target where its shard
    holds it (a partial sum over the vocab's mesh dims).  So backward hands
    each rank the gradient of its own shard; DTensor's own ops re-lay the
    (B, S, V) gradient out over the batch instead, an all-to-all of the
    logits.  With the vocab whole this is the plain function, op for op."""
    mesh = logits.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p
               for p in logits.placements)
    vocab_dims = [m for m, p in enumerate(pl) if p == Shard(2)]
    V_local = logits.shape[-1] // math.prod(mesh.size(m)
                                            for m in vocab_dims)
    # this rank's first vocab entry: its coordinates on the vocab's mesh
    # dims, the first the most significant (DTensor's order of the shards)
    block = 0
    for m in vocab_dims:
        block = block * mesh.size(m) + mesh.get_coordinate()[m]
    rows = tuple(Replicate() if p == Shard(2) else p for p in pl)
    picked_pl = tuple(Partial() if p == Shard(2) else p for p in pl)
    # one logsumexp per vocab shard, along a new leading dim
    parts_pl = tuple(Shard(0) if p == Shard(2) else
                     Shard(p.dim + 1) if p.is_shard() else p for p in pl)

    def local(lg, tg):
        idx = tg.to(torch.int64) - block * V_local
        mine = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        lse = torch.logsumexp(lg, dim=-1)
        return (lse[None] if vocab_dims else lse,
                torch.where(mine, got[..., 0], 0.0))

    lse, picked = local_map(
        local, out_placements=(parts_pl if vocab_dims else rows, picked_pl),
        in_placements=(pl, rows), in_grad_placements=(pl, rows),
        device_mesh=mesh, redistribute_inputs=True)(logits, targets)
    if vocab_dims:
        lse = torch.logsumexp(lse, dim=0)
    return lse, picked


def _total(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()``.  On a DTensor each rank sums its own shard, the result
    a partial sum over the mesh dims that split ``x``: backward then hands
    each rank the gradient of its shard, where DTensor's own sum hands
    every rank a gradient expanded to ``x``'s whole shape."""
    if not isinstance(x, DTensor):
        return x.sum()
    # a partial value is reduced first (a partial max sums to nothing)
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    out = tuple(Partial() if p.is_shard() else p for p in pl)
    return local_map(
        lambda t: (t.sum(),), out_placements=(out,), in_placements=(pl,),
        in_grad_placements=(pl,), device_mesh=x.device_mesh,
        redistribute_inputs=True)(x)[0]


def top1_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    hit = (torch.argmax(logits, dim=-1) == targets).to(torch.float32)
    if mask is None:
        return hit.mean()
    m = mask.to(torch.float32)
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)
