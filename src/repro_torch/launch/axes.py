"""Logical-axis activation sharding constraints on DTensor.

The JAX package's ``launch/axes.py`` in PyTorch.  Model code calls
``constrain(x, "batch", None, "tp")`` with logical names; the mesh is
ambient (``mesh_context``, set by ``launch/steps.py`` around a cell's
step).  Pinning activations to ``(batch, ..., tp)`` makes gathering the
FSDP weight shards, not all-reducing batch-replicated activations, the
layout every layer starts from.

``constrain`` returns ``x`` itself when no mesh is ambient and when ``x``
is a plain tensor, so the one-device path keeps its numbers bit for bit.
For a DTensor it resolves the logical spec on the ambient mesh, checks
divisibility through ``fix_spec`` with relocation disabled (a batch of 1
drops the batch axis), and redistributes ``x`` where its placements
differ.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import NamedSharding, fix_spec

__all__ = ["constrain", "mesh_context", "current_mesh", "current_profile",
           "placements", "local_shards", "einsum", "stack",
           "contiguous_strides", "laid_out_like", "spec_of", "local_like"]

_STATE = threading.local()

# sharding profiles (see launch/sharding.py):
#   "tp_fsdp" (default): batch over (pod, data); TP over model; FSDP data
#   "fsdp":   batch over (pod, data, model); no activation TP (pure ZeRO-3)
#   "serve":  like tp_fsdp for activations; params keep TP but drop FSDP
_PROFILES = {
    "tp_fsdp": {"batch": ("pod", "data"), "fsdp": ("data",),
                "tp": ("model",)},
    "fsdp": {"batch": ("pod", "data", "model"), "fsdp": ("data",),
             "tp": ()},
    "serve": {"batch": ("pod", "data"), "fsdp": ("data",),
              "tp": ("model",)},
}


def current_mesh():
    return getattr(_STATE, "mesh", None)


def current_profile() -> str:
    return getattr(_STATE, "profile", "tp_fsdp")


@contextlib.contextmanager
def mesh_context(mesh, profile: str = "tp_fsdp"):
    prev = current_mesh()
    prev_prof = current_profile()
    _STATE.mesh = mesh
    _STATE.profile = profile
    try:
        yield
    finally:
        _STATE.mesh = prev
        _STATE.profile = prev_prof


def _resolve(axis, mesh):
    if axis is None:
        return None
    logical = _PROFILES[current_profile()]
    names = logical.get(axis, (axis,))
    present = tuple(a for a in names if a in axis_sizes(mesh))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that the spec names, ``Replicate()`` elsewhere.

    A mesh dim of size 1 is ``Replicate()`` whatever the spec says: on it
    the two hold the same data, and DTensor refuses a view that folds a
    sharded dim of size 1 into another (``einsum`` does, on one KV head).
    """
    return tuple(Replicate() if isinstance(p, Shard) and size == 1 else p
                 for p, size in zip(NamedSharding(mesh, spec).placements,
                                    mesh.shape))


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` whose gradient comes back replicated
    over the mesh dims where ``x`` was a partial sum.

    The gradient of each partial summand is the whole gradient of the sum,
    so this is the same function as DTensor's own backward, which lays that
    gradient out as a partial sum instead; a matmul given a partial-sum
    gradient then gathers its weights whole rather than reduce it
    (Megatron's f/g pair, where the backward of the all-reduce is the
    identity)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.back:
            grad = grad.redistribute(ctx.mesh, ctx.back)
        return grad, None, None


def constrain(x: torch.Tensor, *logical_spec) -> torch.Tensor:
    """Pin the DTensor ``x`` to a logical sharding if an ambient mesh is
    set; a plain tensor, or no mesh, passes through untouched."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = tuple(_resolve(a, mesh) for a in logical_spec)
    fixed = fix_spec(x.shape, spec, mesh, relocate=False)
    want = placements(mesh, fixed)
    if tuple(x.placements) == want:
        return x
    return _Redistribute.apply(x, mesh, want)


def laid_out_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` in ``ref``'s layout: partial sums or means
    reduced, and scattered where ``ref`` is split (FSDP's reduce-scatter of
    a gradient).  Left as DTensor leaves them, a partial meets another
    operand and both are gathered whole.  A plain tensor passes through."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(
            ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def local_shards(fn, mesh, args: tuple, in_specs: tuple, out,
                 out_partial: tuple = ()):
    """``fn(*args)`` on each rank's shards, as ``jax.shard_map`` runs it.

    Each DTensor of ``args`` is laid out first by its spec in
    ``in_specs`` (``None`` for an argument that is not a tensor) and
    ``fn`` takes the local tensors.  ``out`` is the output's ``(shape,
    spec)``, or a list of them for a tuple of outputs: each comes back a
    DTensor laid out by its spec, and a partial sum over the mesh axes
    named in ``out_partial``.  A spec names mesh axes per dim; a dim that
    does not divide its axes is whole (``fix_spec`` without relocation).

    Under autograd an argument's gradient comes back laid out as the
    argument, except on the mesh dims that split an output (or leave it a
    partial sum) and not the argument: each rank's gradient is a partial
    sum there.  The layouts
    are the specs', not chosen op by op by DTensor, whose choices for
    views, pads and scatters change from one torch release to the next.
    """
    def laid(shape, spec):
        return placements(mesh, fix_spec(tuple(shape), tuple(spec), mesh,
                                         relocate=False))

    names = mesh.mesh_dim_names
    one = not isinstance(out, list)
    outs = [out] if one else out
    out_pl = [tuple(Partial() if names[i] in out_partial else p
                    for i, p in enumerate(laid(shape, spec)))
              for shape, spec in outs]
    split = [any(not o[i].is_replicate() for o in out_pl)
             for i in range(len(names))]
    in_pl = tuple(None if spec is None else laid(a.shape, spec)
                  for a, spec in zip(args, in_specs))
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if split[i] and p.is_replicate() else p
        for i, p in enumerate(pl)) for pl in in_pl)
    mapped = local_map(
        (lambda *a: (fn(*a),)) if one else fn,
        out_placements=tuple(out_pl), in_placements=in_pl,
        in_grad_placements=grad_pl, device_mesh=mesh,
        redistribute_inputs=True)(*args)
    return mapped[0] if one else mapped


def spec_of(x: DTensor) -> tuple:
    """The spec of a DTensor's layout: per dim the mesh axes that split
    it (a name, a tuple of names, or ``None``), pod-major as
    ``NamedSharding`` lays tuples out.  A partial sum is no layout a spec
    can name, and raises."""
    names = x.device_mesh.mesh_dim_names
    split = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if p.is_partial():
            raise ValueError(f"{x.placements} holds a partial sum")
        if p.is_shard():
            split[p.dim].append(name)
    return tuple(None if not s else s[0] if len(s) == 1 else tuple(s)
                 for s in split)


def local_like(fn, x: torch.Tensor, shape=None, whole=()) -> torch.Tensor:
    """``fn(x)`` for a DTensor ``x``, each rank on its shard in ``x``'s own
    layout, the dims in ``whole`` gathered first; the output, of
    ``shape`` (``x``'s by default) and as many dims, comes back laid out
    like ``x``.  A plain tensor is ``fn(x)``.  For pads and slices along a
    dim, which DTensor lays out op by op and differently from one torch
    release to the next (:func:`local_shards`)."""
    if not isinstance(x, DTensor):
        return fn(x)
    spec = tuple(None if d in whole else s
                 for d, s in enumerate(spec_of(x)))
    return local_shards(fn, x.device_mesh, (x,), (spec,),
                        (tuple(x.shape if shape is None else shape), spec))


def einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum``; where an operand is a DTensor, each rank contracts
    its shards (:func:`local_shards`).

    Each mesh dim keeps the first split it finds among the operands'
    placements on a label that divides it, and every operand holding that
    label is split the same way; an operand without it is whole on that
    mesh dim.  A kept label of the output splits the output; a contracted
    one leaves the output a partial sum over that mesh dim.  Every other
    dim is gathered first.  (DTensor's own einsum flattens labels into
    views whose splits differ from one torch release to the next.)
    """
    dts = [o for o in operands if isinstance(o, DTensor)]
    if not dts:
        return torch.einsum(equation, *operands)
    mesh = dts[0].device_mesh
    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    size = {lab: n for spec, op in zip(ins, operands)
            for lab, n in zip(spec, op.shape)}
    axes_of: dict[str, list] = {}
    for m, name in enumerate(mesh.mesh_dim_names):
        for spec, op in zip(ins, operands):
            p = op.placements[m] if isinstance(op, DTensor) else None
            if p is None or not p.is_shard():
                continue
            lab = spec[p.dim]
            ways = math.prod(mesh.size(i) for i in axes_of.get(lab, []))
            if size[lab] % (ways * mesh.size(m)) == 0:
                axes_of.setdefault(lab, []).append(m)
                break
    names = mesh.mesh_dim_names

    def spec_of(labels):
        return tuple(tuple(names[m] for m in axes_of[lab])
                     if lab in axes_of else None for lab in labels)

    partial = tuple(names[m] for lab, ms in axes_of.items()
                    if lab not in out for m in ms)
    return local_shards(
        lambda *local: torch.einsum(equation, *local), mesh, operands,
        tuple(spec_of(spec) for spec in ins),
        (tuple(size[lab] for lab in out), spec_of(out)),
        out_partial=partial)


def stack(tensors: list) -> torch.Tensor:
    """``torch.stack`` along a new dim 0; DTensors of one layout are
    stacked shard by shard (their placements shift by one dim)."""
    if not isinstance(tensors[0], DTensor):
        return torch.stack(tensors)
    first = tensors[0]
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in first.placements]
    local = torch.stack([t.redistribute(first.device_mesh, first.placements)
                         .to_local() for t in tensors])
    shape = (len(tensors), *first.shape)
    return DTensor.from_local(local, first.device_mesh, pl, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides, worked out without making a tensor of that shape)."""
    strides, step = [], 1
    for n in reversed(tuple(shape)):
        strides.append(step)
        step *= max(n, 1)
    return tuple(reversed(strides))
