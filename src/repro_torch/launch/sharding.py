"""Sharding rules: parameter / optimizer-state / cache / batch specs.

The JAX package's ``launch/sharding.py`` on ``torch.distributed``.
MaxText-style logical layout on a ("pod"?, "data", "model") mesh:

* batch            -> ("pod", "data")      (pods are pure DP; see fault.py)
* vocab / heads / experts / ffn / d_inner  -> "model"   (tensor parallel)
* d_model (embed) on weight matrices       -> "data"    (ZeRO-3 / FSDP)
* scanned-layer leading axis               -> replicated
* optimizer state mirrors its parameter (factored Adafactor states inherit
  the parameter's spec minus the reduced dimension)

Rules are keyed on the *leaf name* (the last key in the parameter path,
``repro_torch.tree``'s paths, which follow the reference's) and the leaf's
rank, so they apply uniformly to every architecture in the zoo.  A spec
(:class:`Spec`) has one entry per dim: ``None``, an axis name, or a tuple
of names.  Arguments must divide evenly by their mesh axes, so
``fix_spec`` relocates a mesh axis to a dividing dim (8 KV heads can't
split 16 ways -> shard head_dim instead) or drops it.

The rules read only shapes (tensors on any device, ``meta`` included) and
a mesh's axis sizes (``launch.mesh.axis_sizes``).  :func:`named` turns
specs into DTensor placements on a ``DeviceMesh`` -- one ``Shard(dim)`` or
``Replicate()`` per mesh dim, a dim sharded over ("pod", "data") being
``Shard(dim)`` on both, pod-major as in JAX -- and :func:`place` puts a
tree onto the mesh with them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["Spec", "NamedSharding", "fix_spec", "param_specs",
           "opt_state_specs", "batch_specs", "cache_specs_tree", "named",
           "place", "spec_bytes_per_device"]

# body specs EXCLUDING any leading scanned-layer axis (prepended if present)
_FSDP = "data"
_TP = "model"

_BODY_RULES: dict[tuple[str, int], tuple] = {
    # attention
    ("wq", 3): (_FSDP, _TP, None),
    ("wk", 3): (_FSDP, _TP, None),
    ("wv", 3): (_FSDP, _TP, None),
    ("wo", 3): (_TP, None, _FSDP),
    # dense / shared-expert MLPs
    ("w_gate", 2): (_FSDP, _TP),
    ("w_up", 2): (_FSDP, _TP),
    ("w_down", 2): (_TP, _FSDP),
    ("w_fc", 2): (_FSDP, _TP),
    ("w_proj", 2): (_TP, _FSDP),
    ("b_fc", 1): (_TP,),
    ("b_proj", 1): (None,),
    # MoE experts (leading E axis; "we_*" names are the routed experts)
    ("we_gate", 3): (_TP, _FSDP, None),
    ("we_up", 3): (_TP, _FSDP, None),
    ("we_down", 3): (_TP, None, _FSDP),
    ("router", 2): (_FSDP, None),
    # Mamba2 (split per-stream projections; see models/ssm.py)
    ("gate_proj", 2): (_FSDP, _TP),
    ("x_proj", 2): (_FSDP, _TP),
    # B/C/dt projections are tiny (d_model x 128 / x H); TP-sharding their
    # outputs makes the SSD score einsum a reduction -- replicate instead.
    ("B_proj", 2): (_FSDP, None),
    ("C_proj", 2): (_FSDP, None),
    ("dt_proj", 2): (_FSDP, None),
    ("out_proj", 2): (_TP, _FSDP),
    ("conv_x", 2): (None, _TP),
    ("conv_x_b", 1): (_TP,),
    ("conv_B", 2): (None, _TP),
    ("conv_B_b", 1): (_TP,),
    ("conv_C", 2): (None, _TP),
    ("conv_C_b", 1): (_TP,),
    ("conv_w", 2): (None, _TP),
    ("conv_b", 1): (_TP,),
    ("A_log", 1): (_TP,),
    ("D", 1): (_TP,),
    ("dt_bias", 1): (_TP,),
    ("norm_scale", 1): (_TP,),
    # RG-LRU
    ("in_gelu", 2): (_FSDP, _TP),
    ("in_rnn", 2): (_FSDP, _TP),
    ("w_a", 2): (None, _TP),
    ("w_x", 2): (None, _TP),
    ("b_a", 1): (_TP,),
    ("b_x", 1): (_TP,),
    ("Lambda", 1): (_TP,),
    ("out", 2): (_TP, _FSDP),
    # norms: tiny, replicated
    ("scale", 1): (None,),
    ("bias", 1): (None,),
}

_TOP_RULES: dict[str, tuple] = {
    "embed": (_TP, _FSDP),       # (V, D)
    "lm_head": (_FSDP, _TP),     # (D, V)
}


def _entry(ax):
    """A spec entry as JAX's ``PartitionSpec`` keeps it: a one-name tuple
    is the name, an empty one ``None``."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


class Spec:
    """A partition spec: one entry per dim, ``None`` (replicated), an axis
    name, or a tuple of names (sharded over their product, the first
    major).  Iterable, and a leaf of ``repro_torch.tree`` (not a tuple);
    equal to any spec or tuple with the same entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __eq__(self, other):
        if isinstance(other, (Spec, tuple)):
            return self._entries == tuple(other)
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"Spec{self._entries!r}"


def _leaf_name(path) -> str:
    return str(path[-1])


def _axis_size(mesh, ax) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def fix_spec(shape: tuple, spec: tuple, mesh, *,
             relocate: bool = True) -> Spec:
    """Make a proposed spec legal for ``shape`` on ``mesh``.

    Every argument dimension must divide evenly by its mesh axes.  For
    each named axis whose proposed dim does not divide, try to relocate it
    to a later (then earlier) unassigned dim that does divide -- e.g. 8 KV
    heads cannot shard over a 16-way "model" axis, but head_dim=128 can,
    so (..., "model", None) becomes (..., None, "model").  If no dim fits,
    the axis is dropped (replicated).
    """
    shape = tuple(shape)
    spec = tuple(spec)[: len(shape)]
    spec = spec + (None,) * (len(shape) - len(spec))
    out: list = [None] * len(shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        size = _axis_size(mesh, ax)
        candidates = (list(range(i, len(shape))) + list(range(i))
                      if relocate else [i])
        for j in candidates:
            if out[j] is None and spec[j] in (None, ax) \
                    and shape[j] % size == 0:
                out[j] = ax
                break
        # else: dropped (replicated)
    return Spec(*out)


# Attention projections must NOT relocate their TP axis to head_dim when
# the heads don't divide: dh-sharded q/k makes every score matmul a
# reduction of an S x S tensor.  Dropping TP (heads replicated across
# "model", FSDP kept on d_model) is strictly better.
_NO_RELOCATE = {"wq", "wk", "wv", "wo"}


def _spec_for(path, leaf, mesh) -> Spec:
    name = _leaf_name(path)
    ndim = len(leaf.shape)
    reloc = name not in _NO_RELOCATE
    if name in _TOP_RULES and ndim == len(_TOP_RULES[name]):
        return fix_spec(leaf.shape, _TOP_RULES[name], mesh, relocate=reloc)
    if (name, ndim) in _BODY_RULES:
        return fix_spec(leaf.shape, _BODY_RULES[(name, ndim)], mesh,
                        relocate=reloc)
    if (name, ndim - 1) in _BODY_RULES:  # stacked: leading repeats axis
        return fix_spec(leaf.shape,
                        (None,) + _BODY_RULES[(name, ndim - 1)], mesh,
                        relocate=reloc)
    return Spec()  # replicate anything unmatched (scalars, counters, ...)


def param_specs(params_shapes: Any, mesh, profile: str = "tp_fsdp") -> Any:
    """Spec tree matching a params (shape) tree.

    profile "serve" drops the FSDP axis (weights stay TP-sharded,
    replicated over data): serving must not re-gather weights per token.
    """
    specs = [_spec_for(p, l, mesh) for p, l in leaves_with_path(params_shapes)]
    if profile == "serve":
        specs = [Spec(*(None if ax == _FSDP else ax for ax in sp))
                 for sp in specs]
    return unflatten(params_shapes, specs)


def _shape_of(leaf):
    return tuple(getattr(leaf, "shape", ()))


def opt_state_specs(opt_shapes: Any, pspecs: Any, mesh) -> Any:
    """Optimizer-state specs.

    m/v mirror their parameter; Adafactor's factored "vr" (param minus last
    dim) and "vc" (param minus second-to-last) drop that entry of the spec;
    scalars (step/gnorm/lr) replicate.
    """
    by_path = {tuple(map(str, p)): s for p, s in leaves_with_path(pspecs)}

    def spec_of(path, leaf):
        names = [str(p) for p in path]
        shape = _shape_of(leaf)
        if not names or names[0] in ("step", "gnorm", "lr"):
            return Spec()
        kind = names[0]              # "m" | "v" | ...
        rest = tuple(names[1:])
        if kind in ("m", "v") and rest and rest[-1] in ("vr", "vc", "v"):
            sub, rest = rest[-1], rest[:-1]
        else:
            sub = None
        pspec = by_path.get(rest)
        if pspec is None:
            return Spec()
        spec = tuple(pspec)
        if len(spec) < len(shape):
            spec = spec + (None,) * (len(shape) - len(spec))
        if sub == "vr":
            spec = spec[:-1]
        elif sub == "vc":
            spec = spec[:-2] + spec[-1:]
        if len(spec) != len(shape):
            spec = spec[: len(shape)]
        return fix_spec(shape, spec, mesh)

    return unflatten(opt_shapes, [spec_of(p, l)
                                  for p, l in leaves_with_path(opt_shapes)])


def batch_specs(batch_shapes: Any, mesh, profile: str = "tp_fsdp") -> Any:
    """Shard dim 0 of every batch leaf over the batch axes; scalars
    replicate."""
    baxes = batch_axes(mesh)
    if profile == "fsdp":  # pure-DP: the model axis also carries batch
        baxes = tuple(a for a in ("pod", "data", "model")
                      if a in axis_sizes(mesh))

    def spec(leaf):
        shape = _shape_of(leaf)
        if len(shape) == 0:
            return Spec()
        return fix_spec(shape, (baxes,) + (None,) * (len(shape) - 1),
                        mesh, relocate=False)

    return tree_map(spec, batch_shapes)


def cache_specs_tree(cache_shapes: Any, mesh) -> Any:
    """Decode caches: (reps, B, ...) leaves -> batch on dim 1, heads/model
    dims heuristically on the axis whose name matches, else replicated.

    Cache layouts (see transformer.init_cache):
      k/v   (reps, B, S, n_kv, Dh) -> (None, batch, None, "model", None)
      pos   (reps, B, W)           -> (None, batch, None)
      conv  (reps, B, K, C)        -> (None, batch, None, "model")
      state (reps, B, H, P, N)     -> (None, batch, "model", None, None)
      h     (reps, B, R)           -> (None, batch, "model")
    Every 5-D leaf takes the k/v rule, as in the reference, so the
    "state" rule applies only to a leaf of another rank.
    """
    baxes = batch_axes(mesh)

    def _first_legal(shape, candidates):
        """First candidate whose named axes all survive fix_spec."""
        best = None
        for prop in candidates:
            want = sum(1 for a in prop if a is not None)
            fixed = fix_spec(shape, prop, mesh, relocate=False)
            got = sum(1 for a in fixed if a is not None)
            if best is None:
                best = fixed
            if got == want:
                return fixed
        return best

    def spec(path, leaf):
        name = str(path[-1])
        shape = _shape_of(leaf)
        nd = len(shape)
        if nd == 5:
            # KV caches (reps, B, S, n_kv, Dh): head-parallel when the KV
            # heads divide the TP axis, else context-parallel on S
            # (flash-decoding style) so the cache never replicates.
            return _first_legal(shape, [(None, baxes, None, _TP, None),
                                        (None, baxes, _TP, None, None)])
        if name == "state":
            prop = (None, baxes, _TP, None, None)
        elif name == "conv":
            prop = (None, baxes, None, _TP)
        elif name == "h":
            prop = (None, baxes, _TP)
        elif name == "pos":
            prop = (None, baxes, None)
        else:
            prop = (None,) * nd
        return fix_spec(shape, prop, mesh, relocate=False)

    return unflatten(cache_shapes, [spec(p, l) for p, l in
                                    leaves_with_path(cache_shapes)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a :class:`DeviceMesh`, with its DTensor placements."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh dim."""
        names = self.mesh.mesh_dim_names
        dim_of: dict[str, int] = {}
        for dim, ax in enumerate(self.spec):
            axes = ax if isinstance(ax, tuple) else (ax,)
            if ax is None:
                continue
            if any(a not in names for a in axes):
                raise ValueError(f"{self.spec} names an axis not in the "
                                 f"mesh's {names}")
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"{self.spec}: a dim's axes must follow the "
                                 f"mesh's order {names}")
            for a in axes:
                if a in dim_of:
                    raise ValueError(f"{self.spec} uses axis {a!r} twice")
                dim_of[a] = dim
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in names)


def named(mesh: DeviceMesh, spec_tree: Any) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def place(tree: Any, mesh: DeviceMesh, spec_tree: Any) -> Any:
    """``tree``'s tensors as DTensors on ``mesh``, each laid out by its
    spec (``jax.device_put`` with :func:`named`'s shardings); rank 0's
    values are scattered to the others."""
    return tree_map(
        lambda x, s: distribute_tensor(
            torch.as_tensor(x).to(mesh.device_type), mesh,
            NamedSharding(mesh, s).placements), tree, spec_tree)


def spec_bytes_per_device(shapes: Any, specs: Any, mesh) -> int:
    """Estimated per-device bytes for a (shape, spec) tree pair."""
    sizes = axis_sizes(mesh)
    total = 0
    for leaf, spec in zip(leaves(shapes), leaves(specs)):
        shape = list(leaf.shape)
        for i, ax in enumerate(tuple(spec)[: len(shape)]):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            div = math.prod(sizes[a] for a in axes)
            shape[i] = -(-shape[i] // div)
        total += math.prod(shape) * leaf.dtype.itemsize
    return total
