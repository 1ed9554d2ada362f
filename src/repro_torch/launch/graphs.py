"""Step functions replayed from CUDA graphs: the port's ``jax.jit``.

The reference compiles each cell with ``jax.jit(..., donate_argnums=...)``
(``launch/steps.py``) and its train loop steps through that.  On a card
the port captures a step function in a ``torch.cuda.CUDAGraph`` once per
argument signature and replays it, as ``jax.jit`` compiles once per
shape.  :class:`GraphedStep` does that for any step whose arguments are
trees of tensors (plain or DTensor), each leaf in one of four roles:

* :data:`REF` — read in place (the parameters of a prefill or decode
  step): the graph reads the caller's own tensors, so other tensors of
  the same shape capture anew, in place of the capture that read the
  earlier ones (a step holds one capture per signature of its other
  arguments: a caller who passes new parameters each call recaptures
  each call, but holds no more memory);
* :data:`COPY` — copied into the graph's own buffer before each replay
  (a batch, a token, a position);
* :data:`INOUT` — updated in place by the step (decode caches): copied
  into the graph's own buffer before each replay and back into the
  caller's tensor after it, so the caller's tensors hold the new
  entries, as eagerly; the output that aliases the buffer is returned as
  the caller's tensor;
* :data:`DONATE` — the counterpart of ``donate_argnums`` (a train step's
  parameters and optimizer state): the graph owns the buffer, the
  capture writes the step's new values back into it (``writeback`` names
  which output goes where), and the call returns that buffer.  A caller
  that passes it back, as a train loop does, copies nothing; one that
  passes other tensors has them copied in, and the buffers the previous
  call returned then hold this call's values.

Every other output is copied out of the graph's private pool, so a later
call never overwrites what an earlier call returned.  Non-tensor leaves
(an int position, a Python flag) are part of the signature.

A capture (:func:`record`, which the server's decode graphs share)
warms the step up twice on a side stream (cuBLAS handles, autograd's
first-use state, the kernels' builds), then records it; a capture or
replay that fails raises, and nothing falls back to eager.  ``log``
records each capture's seconds and pool bytes.  The CPU has no graphs:
callers run their steps eagerly there.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["REF", "COPY", "INOUT", "DONATE", "GraphedStep", "Recorded",
           "record", "wants_graphs"]

REF, COPY, INOUT, DONATE = "ref", "copy", "inout", "donate"

#: steps run on a side stream before a capture
WARMUP_STEPS = 2


def wants_graphs(graphs: Optional[bool], device_type: str) -> bool:
    """The ``graphs=`` switch of the functions that make steps: ``None``
    is on for a card and off elsewhere; ``True`` where there is no card
    raises."""
    if graphs is None:
        return device_type == "cuda"
    if graphs and device_type != "cuda":
        raise ValueError(f"graphs=True needs a card; this step runs on "
                         f"{device_type}")
    return bool(graphs)


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _owned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in storage of its own, a DTensor laid out as
    ``x``."""
    if isinstance(x, DTensor):
        return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                                  x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.clone()


class Recorded(NamedTuple):
    """A captured graph, the outputs its capture returned (its static
    outputs, rewritten by every replay), its private pool's bytes and the
    capture's seconds."""

    graph: torch.cuda.CUDAGraph
    out: object
    pool_bytes: int
    capture_seconds: float


#: the warm-up stream of each card: one for every capture, since cuBLAS
#: keeps a workspace (32 MiB on Hopper) for each stream it has run on
_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(key)
    return _SIDE_STREAMS[key]


def record(step: Callable[[], object], device: torch.device, *,
           warm: Optional[Callable[[], object]] = None,
           thread_local: bool = False) -> Recorded:
    """Capture ``step()`` in a CUDA graph on ``device``: first run
    ``warm`` (``step`` by default) :data:`WARMUP_STEPS` times on a side
    stream, then record ``step``; ``thread_local`` picks the capture's
    ``capture_error_mode`` (other threads' CUDA calls, such as NCCL's
    watchdog, stay legal)."""
    warm = step if warm is None else warm
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            warm()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    start = time.perf_counter()
    mode = "thread_local" if thread_local else "global"
    # torch.cuda.graph synchronizes and empties the cache on entry, so
    # what is reserved during the capture is the graph's private pool
    with torch.cuda.graph(graph, capture_error_mode=mode):
        reserved = torch.cuda.memory_reserved(device)
        out = step()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    torch.cuda.synchronize(device)
    return Recorded(graph, out, pool_bytes, time.perf_counter() - start)


def _leaf_key(x, role: str):
    """A leaf's part of the signature: what a capture bakes in, less the
    storage of a :data:`REF` leaf (see :meth:`GraphedStep.__call__`)."""
    if not isinstance(x, torch.Tensor):
        return ("value", x)
    key = (role, tuple(x.shape), x.dtype)
    if isinstance(x, DTensor):
        key += (tuple(x.placements),)
    return key


def _refs(flat: list, roles: list) -> tuple:
    """The storage of every :data:`REF` leaf, which a capture reads in
    place."""
    return tuple(_local(x).data_ptr() for f, rs in zip(flat, roles)
                 for x, r in zip(f, rs) if r == REF)


class _Capture:
    """One captured step: the graph, its argument buffers (per argument, a
    flat list of leaves as the caller's), and its outputs."""

    def __init__(self, step: Callable, args: tuple, roles: list,
                 writeback: dict, device: torch.device, thread_local: bool):
        self.args = [[(_owned(x) if isinstance(x, torch.Tensor)
                       and role != REF else x)
                      for x, role in zip(leaves(a), r)]
                     for a, r in zip(args, roles)]
        self.refs = _refs(self.args, roles)
        static = tuple(unflatten(a, flat) for a, flat in zip(args, self.args))

        def captured():
            # a donated argument is written by the capture only: the
            # warm-up leaves the buffers as they were
            out = step(*static)
            for o, a in writeback.items():
                new = [_local(x) for x in leaves(out[o])]
                into = [_local(x) for x in self.args[a]]
                if [(t.shape, t.dtype) for t in new] != \
                        [(t.shape, t.dtype) for t in into]:
                    raise ValueError(f"output {o} is not laid out as "
                                     f"argument {a}, which it replaces")
                torch._foreach_copy_(into, new)
            return out

        rec = record(captured, device, warm=lambda: step(*static),
                     thread_local=thread_local)
        self.graph, self.out = rec.graph, rec.out
        self.pool_bytes, self.capture_seconds = (rec.pool_bytes,
                                                 rec.capture_seconds)
        # outputs that are argument buffers: (argument, leaf) by identity
        self.aliases = {id(x): (a, i) for a, flat in enumerate(self.args)
                        for i, (x, role) in enumerate(zip(flat, roles[a]))
                        if role == INOUT}


class GraphedStep:
    """``step(*args)`` replayed from a CUDA graph captured once per
    argument signature (leaf paths, shapes, dtypes, layouts, roles) and
    storage of the :data:`REF` leaves; one capture is held per signature,
    so new :data:`REF` storage replaces the capture that read the old.

    ``role(argnum, path)`` names each tensor leaf's role (the module
    docstring); ``writeback`` maps an output index (of a tuple-returning
    step) to the :data:`DONATE` argument it replaces.  Call it as the step
    itself.
    """

    def __init__(self, step: Callable, role: Callable[[int, tuple], str],
                 *, writeback: Optional[dict] = None):
        self.step = step
        self.role = role
        self.writeback = dict(writeback or {})
        self._captures: dict = {}
        #: one entry per capture made: its seconds, pool bytes, tensor
        #: arguments
        self.log: list[dict] = []

    @property
    def captures(self) -> int:
        """Captures made, replaced ones included."""
        return len(self.log)

    @property
    def graphs(self) -> list[torch.cuda.CUDAGraph]:
        """The graphs held, one per signature, in capture order
        (``replay()`` reruns one on its buffers as they stand)."""
        return [cap.graph for cap in self._captures.values()]

    def _roles(self, args) -> list:
        out = []
        for a, arg in enumerate(args):
            roles = []
            for path, x in leaves_with_path(arg):
                role = self.role(a, path) if isinstance(x, torch.Tensor) \
                    else "value"
                if role == DONATE and a not in self.writeback.values():
                    raise ValueError(f"argument {a} is donated but no "
                                     f"output is written back into it")
                roles.append(role)
            out.append(roles)
        return out

    def __call__(self, *args):
        roles = self._roles(args)
        flat = [leaves(a) for a in args]
        key = tuple((a, tuple(_leaf_key(x, r) for x, r in zip(f, rs)))
                    for a, (f, rs) in enumerate(zip(flat, roles)))
        cap = self._captures.get(key)
        if cap is not None and cap.refs != _refs(flat, roles):
            # the graph reads other tensors in place: drop it (and the
            # tensors, buffers and pool it holds) before capturing anew
            del self._captures[key]
            cap = None
        if cap is None:
            tensors = [x for f in flat for x in f
                       if isinstance(x, torch.Tensor)]
            if not tensors:
                raise ValueError("a graphed step needs tensor arguments")
            device = _local(tensors[0]).device
            if device.type != "cuda":
                raise ValueError(f"CUDA graphs need card tensors, got "
                                 f"{device}")
            cap = _Capture(self.step, args, roles, self.writeback, device,
                           thread_local=any(isinstance(x, DTensor)
                                            for x in tensors))
            self._captures[key] = cap
            self.log.append({"capture_seconds": cap.capture_seconds,
                             "pool_bytes": cap.pool_bytes,
                             "tensors": len(tensors)})
        src, dst = [], []
        for f, rs, mine in zip(flat, roles, cap.args):
            for x, r, s in zip(f, rs, mine):
                if r in (COPY, INOUT, DONATE) and x is not s:
                    src.append(_local(x))
                    dst.append(_local(s))
        if dst:
            torch._foreach_copy_(dst, src)
        cap.graph.replay()
        back_src, back_dst = [], []
        for f, rs, mine in zip(flat, roles, cap.args):
            for x, r, s in zip(f, rs, mine):
                if r == INOUT and x is not s:
                    back_src.append(_local(s))
                    back_dst.append(_local(x))
        if back_dst:
            torch._foreach_copy_(back_dst, back_src)
        return self._outputs(cap, flat)

    def _outputs(self, cap: _Capture, flat: list):
        out = cap.out
        if not isinstance(out, tuple):
            return self._copy_out(cap, out, flat)
        return tuple(unflatten(o, cap.args[self.writeback[i]])
                     if i in self.writeback else self._copy_out(cap, o, flat)
                     for i, o in enumerate(out))

    @staticmethod
    def _copy_out(cap: _Capture, tree, flat: list):
        def one(x):
            if not isinstance(x, torch.Tensor):
                return x
            alias = cap.aliases.get(id(x))
            if alias is not None:
                a, i = alias
                return flat[a][i]
            return _owned(x)
        return tree_map(one, tree)
