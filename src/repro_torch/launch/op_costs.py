"""Per-device costs of one call, counted op by op.

The port's counterpart of the JAX package's ``launch/hlo_costs.py``.
There is no HLO to parse: :func:`module_costs` runs the function under a
``TorchDispatchMode`` and counts, per device, the ops that reach plain
tensors -- a DTensor op is the global view, and what a rank runs is the
local ops DTensor dispatches beneath it, so only those are counted (a
DTensor matmul would otherwise count its global product as well):

* FLOPs of matmuls, convolutions and attention through
  ``torch.utils.flop_counter``'s formulas (elementwise FLOPs are not
  counted, as in the reference);
* HBM bytes at op boundaries: every tensor an op reads plus every tensor it
  writes, views and allocations excluded -- an upper bound, since eager
  PyTorch fuses nothing (the reference counts at XLA's fusion boundaries);
* the functional collectives (``_c10d_functional.*``) DTensor issues when
  it redistributes, at the bytes a ring moves per device for their group's
  size (``launch.roofline.ring_bytes``, shared with the roofline pass);
* a hand-written kernel as the one op it is on the card: fake tensors
  cannot launch it, so its wrapper hands :func:`as_kernel` empty outputs
  of the kernel's shapes, counted at the kernel's own FLOPs, its inputs
  read once and its outputs written once (``kernels.ops``: flash
  attention and the SSD scan).  Nor does the memory tracker see the
  plain version's intermediates, which the kernel never makes.

The reference also reports ``trip_counts``, the trip count of each
``while`` loop, because XLA's cost analysis counts a loop body once.  The
port's layer groups are Python loops that run every iteration through the
counter, so it has nothing to correct and no such field.

DTensor runs each op once more on fake global-shape tensors to learn its
output's shape (on a sharding-cache miss only); its planning runs with
every dispatch mode out of the way.  :func:`cell_costs` costs a ``launch.steps.Cell`` on fake DTensors
(``FakeTensorMode``), so a full config on a production mesh allocates
nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import CollectiveStats, ring_bytes

__all__ = ["ModuleCosts", "module_costs", "cell_costs", "as_kernel"]

#: functional collectives -> the reference's HLO op names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}

#: ops that move no data: allocations and metadata
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "detach", "lift_fresh",
         "_local_scalar_dense", "wait_tensor"}


@dataclasses.dataclass
class ModuleCosts:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_counts: dict
    collective_bytes_by_op: dict = dataclasses.field(default_factory=dict)

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.collective_counts),
                               bytes_moved=dict(self.collective_bytes_by_op))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _is_view(func) -> bool:
    """An op whose result aliases its input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


#: the counter of the cost pass running on this thread, if any
_ACTIVE = threading.local()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.costs = ModuleCosts(0.0, 0.0, 0.0, {})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in tensors):
            # the global op: let DTensor dispatch its local ops, which come
            # back through this mode and are counted there
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        namespace = func.namespace
        if namespace == "_c10d_functional" and name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], out, args, kwargs)
            return out
        if func._overloadpacket in flop_registry:
            self.costs.flops += float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if name not in _FREE and not _is_view(func):
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.costs.hbm_bytes += float(sum(map(_nbytes, tensors))
                                          + sum(map(_nbytes, outs)))
        return out

    def _collective(self, op: str, out, args, kwargs) -> None:
        group = kwargs.get("group_name", args[-1])
        n = dist.distributed_c10d._resolve_process_group(group).size()
        result = sum(_nbytes(t) for t in tree_leaves(out)
                     if isinstance(t, torch.Tensor))
        moved = ring_bytes(op, result, n)
        self.costs.collective_bytes += moved
        counts, by_op = (self.costs.collective_counts,
                         self.costs.collective_bytes_by_op)
        counts[op] = counts.get(op, 0) + 1
        by_op[op] = by_op.get(op, 0.0) + moved


@contextlib.contextmanager
def _dtensor_internals_outside_modes():
    """Run DTensor's sharding propagation and its shard-offset math with
    no dispatch mode active.

    Propagation plans on metadata, but runs each op once more on fake
    global-shape tensors to learn its output's shape: seen by the counter
    that would count global work.  The offset of a shard of a dim that two
    mesh dims split is worked out with small scratch tensors and an
    ``int()`` of one, which fails under ``FakeTensorMode``.  With no mode
    active the first makes its fakes in a fake mode of its own and the
    second runs on real scratch tensors.  Only the sites this torch
    release has are wrapped."""
    from torch.distributed.tensor import _utils, placement_types
    from torch.utils._python_dispatch import _disable_current_modes
    prop = DTensor._op_dispatcher.sharding_propagator
    sites = [(owner, name) for owner, name in (
        (prop, "propagate_op_sharding"),
        (prop, "propagate_op_sharding_non_cached"),
        (prop, "_propagate_tensor_meta_non_cached"),
        (_utils, "_compute_local_shape_and_global_offset"),
        (getattr(placement_types, "_StridedShard", None),
         "local_shard_size_and_offset")) if hasattr(owner, name)]
    originals = [vars(owner).get(name) for owner, name in sites]

    def outside(original):
        def run(*a, **k):
            with _disable_current_modes():
                return original(*a, **k)
        return run

    for owner, name in sites:
        setattr(owner, name, outside(getattr(owner, name)))
    try:
        yield
    finally:
        for (owner, name), original in zip(sites, originals):
            if original is None:        # an instance's: the class's again
                delattr(owner, name)
            else:
                setattr(owner, name, original)


def module_costs(fn: Callable, *args, **kwargs) -> ModuleCosts:
    """Per-device :class:`ModuleCosts` of ``fn(*args, **kwargs)``."""
    counter = _Counter()
    outer = getattr(_ACTIVE, "counter", None)
    _ACTIVE.counter = counter
    try:
        with _dtensor_internals_outside_modes(), counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.counter = outer
    return counter.costs


def as_kernel(flops: float, out, *inputs):
    """``out``, the outputs of a kernel that fake tensors cannot launch
    (empty tensors of the kernel's shapes); inside :func:`module_costs`
    they count as that kernel: ``flops`` FLOPs, its tensor ``inputs`` read
    once and ``out`` written once."""
    counter = getattr(_ACTIVE, "counter", None)
    if counter is not None:
        counter.costs.flops += float(flops)
        counter.costs.hbm_bytes += float(sum(
            _nbytes(t) for t in tree_leaves((inputs, out))
            if isinstance(t, torch.Tensor)))
    return out


def _fake_dtensor(meta: torch.Tensor, mesh, spec) -> DTensor:
    """A fake DTensor shaped like ``meta``, laid out by ``spec`` on
    ``mesh``: its local shard is a fake tensor of the shard's shape
    (``fix_spec`` leaves only dims that divide their axes sharded)."""
    from repro_torch.launch.axes import contiguous_strides, placements
    from repro_torch.launch.sharding import fix_spec
    pl = placements(mesh, fix_spec(meta.shape, tuple(spec), mesh,
                                   relocate=False))
    local_shape = list(meta.shape)
    for size, p in zip(mesh.shape, pl):
        if p.is_shard():
            local_shape[p.dim] //= size
    local = torch.empty(local_shape, dtype=meta.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=meta.shape,
                              stride=contiguous_strides(meta.shape))


def cell_costs(cell, *, peak_memory: bool = False) -> Any:
    """``cell.eager``'s per-device :class:`ModuleCosts` on fake DTensors shaped
    like ``cell.arg_shapes`` and laid out by ``cell.in_shardings``.  A
    decode cell steps at the last slot of its caches.  With
    ``peak_memory``, returns ``(costs, peak bytes per device)``, the peak
    from ``torch.distributed._tools.mem_tracker`` in the same run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_map

    with FakeTensorMode(allow_non_fake_inputs=True), \
            _dtensor_internals_outside_modes():
        args = tuple(
            tree_map(lambda m, ns: _fake_dtensor(m, cell.mesh, ns.spec),
                     shapes, named)
            for shapes, named in zip(cell.arg_shapes, cell.in_shardings))
        if cell.kind == "decode":
            args[1]["pos"] = cell.shape.seq_len - 1
        if not peak_memory:
            return module_costs(cell.eager, *args)
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        tracker.track_external(*[x for a in args for x in tree_leaves(a)
                                 if isinstance(x, torch.Tensor)])
        with tracker:
            costs = module_costs(cell.eager, *args)
        peak = tracker.get_tracker_snapshot("peak")
        # the mesh's device only: a meta tensor holds no memory
        return costs, float(max((snap.get("Total", 0)
                                 for dev, snap in peak.items()
                                 if torch.device(dev).type != "meta"),
                                default=0))
