"""Layered gradient all-reduce — the paper's resolution layers on collectives.

The JAX package's ``optim/layered_grads.py`` on ``torch.distributed``.
Gradients are quantized and digit-decomposed
(``repro_torch.core.layering``); the all-reduce then runs
**MSB-plane-first**.  A deadline-bounded synchronous step can apply the
optimizer update from the first plane(s) and feed the unsent remainder
back as error-feedback — the paper's "release a lower resolution at the
deadline" transplanted from task results to gradient collectives.

This module provides the math (plane split / reconstruct) plus an
execution that issues one ``all_reduce`` per plane on the mesh axis's
process group, so the collective schedule is visibly layered.  Plane sums
commute with the decode because the code is linear — summing plane-wise
then reconstructing equals reconstructing then summing, up to the shared
quantization scale.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import layering
from repro_torch.tree import tree_map

__all__ = ["plane_split", "plane_reconstruct", "layered_psum",
           "layered_allreduce_tree"]


def plane_split(g: torch.Tensor, m: int, d: int):
    """Quantize a float gradient tensor and split into m digit planes.

    Returns (planes (m, *g.shape) float32-encoded ints, scale).  Planes are
    float so they ride the regular all-reduce datapath; each plane's values
    fit in d bits (plus sign for the top plane), so a d<=8 plane could be
    shipped as int8 — the dtype choice is the transport's concern.
    """
    q, scale = layering.quantize(g, m * d)
    planes = layering.decompose(q, m, d).to(torch.float32)
    return planes, scale


def plane_reconstruct(planes: torch.Tensor, scale: torch.Tensor, d: int,
                      up_to_plane: int | None = None) -> torch.Tensor:
    """Rebuild the (summed) gradient from the top ``up_to_plane+1`` planes.

    ``up_to_plane`` indexes MSB-first resolutions: 0 = only the top plane.
    """
    m = planes.shape[0]
    k = m if up_to_plane is None else up_to_plane + 1
    acc = torch.zeros(planes.shape[1:], dtype=torch.float32,
                      device=planes.device)
    for i in range(m - 1, m - 1 - k, -1):
        acc = acc + planes[i] * float(1 << (i * d))
    return acc * scale


def layered_psum(planes: torch.Tensor, group=None) -> torch.Tensor:
    """One ``all_reduce(SUM)`` per plane over ``group``, MSB-first — the
    layered collective schedule.

    Each plane is an independent all-reduce so an implementation with a
    deadline can consume the partial sums in layer order.  Returns the
    summed planes; ``planes`` is left as it was.
    """
    out = planes.clone()
    for i in range(out.shape[0] - 1, -1, -1):          # MSB plane first
        dist.all_reduce(out[i], op=dist.ReduceOp.SUM, group=group)
    return out


def layered_allreduce_tree(grads, mesh, axis: str, *, m: int = 2,
                           d: int = 8, resolution: int | None = None):
    """Data-parallel mean of a gradient tree via layered all-reduce.

    Each rank passes its local gradient (what the reference's ``shard_map``
    over ``P(axis)`` hands each device).  Each leaf is quantized with a
    scale shared by the axis's ranks (one ``all_reduce(MAX)`` of |g|'s
    max), plane-split, summed plane-by-plane (MSB first), reconstructed at
    ``resolution`` (None = full), and divided by the axis size.
    """
    group = mesh.get_group(axis)
    n = group.size()
    qmax = float(2 ** (m * d - 1) - 1)

    def per_leaf(g):
        # shared scale: max over ranks so planes are commensurable
        absmax = torch.max(torch.abs(g))
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(absmax, min=1e-30) / qmax
        q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int32)
        planes = layering.decompose(q, m, d).to(torch.float32)
        planes = layered_psum(planes, group)
        return plane_reconstruct(planes, scale, d, resolution) / n

    return tree_map(per_leaf, grads)
