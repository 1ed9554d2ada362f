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

Tracing.  The step's stages are marked where their work is launched
(:func:`mark`).  :func:`record` captures the step twice into one pool:
as it is, and with each mark a timing event recorded into the graph, so
that a replay of that second graph stamps the end of each stage on the
device; outside that capture a mark does nothing.  An event node costs
about 5 us on an H100, 1 % of a full-size decode step, so the marked
graph replays only while ``torch.profiler`` records (:func:`recording`,
the one gate): then a graphed call reads its last replay's stage times
into :data:`stage_log`, and the port's host spans (:func:`span`) are
``record_function`` ranges on the profiler's clock.  With the profiler
off the plain graph replays, and no span is entered and nothing read.
A step may also keep device counters in the marked capture
(:func:`count`), which such a call reads into :data:`counter_log`.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["REF", "COPY", "INOUT", "DONATE", "GraphedStep", "Recorded",
           "record", "wants_graphs", "mark", "stages", "stage_log",
           "recording", "span", "CAPTURE_CALLS", "count", "counting",
           "counter_log"]

REF, COPY, INOUT, DONATE = "ref", "copy", "inout", "donate"

#: steps run on a side stream before a capture
WARMUP_STEPS = 2

#: calls of a step at its capture: the warm-up steps and two captures,
#: plain and marked (so a kernel's wrapper counts this many launches)
CAPTURE_CALLS = WARMUP_STEPS + 2

#: the stage times of graphed calls made while the profiler recorded,
#: newest last: ``{"step": name, "stages": {stage: seconds}}`` of each
#: call's last replay (``serve.decode`` for the server's decode, a
#: :class:`GraphedStep`'s ``name`` otherwise)
stage_log: collections.deque = collections.deque(maxlen=256)

#: the device counters of graphed calls made while the profiler recorded,
#: newest last: ``{"step": name, "counters": {name: [values, ...]}}`` of
#: each call's last replay, one list of ints a :func:`count` call of the
#: step (the dropless expert layer's ``moe.route``: per layer, the held
#: experts that got a pair and the pairs they got)
counter_log: collections.deque = collections.deque(maxlen=256)

#: the marks of the capture :func:`record` is making, else None
_open_marks: Optional[list] = None
#: the counters of that capture, else None
_open_counters: Optional[list] = None

_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether ``torch.profiler`` records on this thread: the gate of every
    span and stage read, far cheaper than entering a ``record_function``
    with no profiler running."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``record_function`` range named ``name`` while the profiler
    records, else a context that does nothing."""
    return record_function(name) if recording() else _NO_SPAN


def mark(name: str) -> None:
    """End the stage ``name`` here, where it began at the previous mark:
    inside a capture by :func:`record`, a timing event recorded into the
    graph; anywhere else (eager calls, the CPU, the warm-up) nothing."""
    if _open_marks is None:
        return
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record()
    _open_marks.append((name, event))


def counting() -> bool:
    """Whether the marked capture of :func:`record` is being made, where
    :func:`count` keeps what it is given."""
    return _open_counters is not None


def count(name: str, value: torch.Tensor) -> None:
    """Keep ``value``, a device tensor the step computes, as the counter
    ``name``: inside the marked capture of :func:`record` it stays
    allocated in the graph's pool, and each replay of that graph rewrites
    it, for :meth:`Recorded.log_stages` to read; anywhere else nothing."""
    if _open_counters is not None:
        _open_counters.append((name, value.detach()))


def stages(marks) -> dict[str, float]:
    """``{stage: seconds}`` of the last replay of a graph captured with
    ``marks`` (a :class:`Recorded`'s), each stage summed over its marks;
    waits for the last mark."""
    if len(marks) < 2:
        return {}
    marks[-1][1].synchronize()
    out: dict[str, float] = {}
    for (_, start), (name, end) in zip(marks, marks[1:]):
        out[name] = out.get(name, 0.0) + start.elapsed_time(end) / 1e3
    return out


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


class Recorded:
    """A step captured twice in one private pool: ``graph`` as it is and
    ``marked`` with its ``marks`` (``(stage, event)``, the first the
    capture's own start).  ``out`` and ``marked_out`` are the outputs each
    capture returned, its static outputs, rewritten by each of its
    replays; ``pool_bytes`` and ``capture_seconds`` are both captures'.
    The two share their pool, so only the outputs of the graph that
    replayed last hold its results."""

    def __init__(self, graph: torch.cuda.CUDAGraph, out,
                 marked: torch.cuda.CUDAGraph, marked_out, marks: tuple,
                 pool_bytes: int, capture_seconds: float,
                 counters: tuple = ()):
        self.graph, self.out = graph, out
        self.marked, self.marked_out, self.marks = marked, marked_out, marks
        self.counters = counters
        self.pool_bytes, self.capture_seconds = pool_bytes, capture_seconds
        #: whether the last replay was the marked graph's
        self.traced = False

    def replay(self):
        """Replay the step, from the marked graph while the profiler
        records; returns the static outputs of the graph that ran."""
        self.traced = recording()
        if self.traced:
            self.marked.replay()
            return self.marked_out
        self.graph.replay()
        return self.out

    def log_stages(self, step: str) -> None:
        """While the profiler records, append the stage times of the last
        replay, if it was the marked graph's, to :data:`stage_log` as
        ``step``."""
        if self.traced and len(self.marks) > 1 and recording():
            stage_log.append({"step": step, "stages": stages(self.marks)})
            if self.counters:
                read: dict[str, list] = {}
                for name, value in self.counters:
                    read.setdefault(name, []).append(value.tolist())
                counter_log.append({"step": step, "counters": read})


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
    """Capture ``step()`` in CUDA graphs on ``device``: first run
    ``warm`` (``step`` by default) :data:`WARMUP_STEPS` times on a side
    stream, then capture ``step`` as it is, then again into the same pool
    with the stage marks (and counters, :func:`count`) it makes after one
    of the capture's own;
    ``thread_local`` picks the captures' ``capture_error_mode`` (other
    threads' CUDA calls, such as NCCL's watchdog, stay legal)."""
    global _open_marks, _open_counters
    warm = step if warm is None else warm
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            warm()
    torch.cuda.current_stream(device).wait_stream(side)
    start = time.perf_counter()
    mode = "thread_local" if thread_local else "global"
    graph, marked = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    marks, counters = [], []
    # torch.cuda.graph synchronizes and empties the cache on entry, so
    # what is reserved during a capture is the graphs' private pool
    with torch.cuda.graph(graph, capture_error_mode=mode):
        reserved = torch.cuda.memory_reserved(device)
        out = step()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    with torch.cuda.graph(marked, pool=graph.pool(),
                          capture_error_mode=mode):
        reserved = torch.cuda.memory_reserved(device)
        _open_marks, _open_counters = marks, counters
        try:
            mark("start")
            marked_out = step()
        finally:
            _open_marks = _open_counters = None
    pool_bytes += torch.cuda.memory_reserved(device) - reserved
    torch.cuda.synchronize(device)
    return Recorded(graph, out, marked, marked_out, tuple(marks), pool_bytes,
                    time.perf_counter() - start, tuple(counters))


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
    """One captured step: its graphs (``rec``) and argument buffers (per
    argument, a flat list of leaves as the caller's)."""

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
            if not writeback:
                return out
            mark("writeback")
            # the written-back outputs are the graph's scratch: return the
            # buffers they went to instead, so that the marked capture
            # places its own in their memory (not 4 GB more for a 370 M
            # parameter AdamW step)
            return tuple(unflatten(x, self.args[writeback[i]])
                         if i in writeback else x for i, x in enumerate(out))

        self.rec = record(captured, device, warm=lambda: step(*static),
                          thread_local=thread_local)
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
    step) to the :data:`DONATE` argument it replaces; ``name`` is the
    step's name in :data:`stage_log`.  Call it as the step itself.
    """

    def __init__(self, step: Callable, role: Callable[[int, tuple], str],
                 *, writeback: Optional[dict] = None, name: str = "step"):
        self.step = step
        self.role = role
        self.name = name
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
        """The plain graphs held, one per signature, in capture order
        (``replay()`` reruns one on its buffers as they stand)."""
        return [cap.rec.graph for cap in self._captures.values()]

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
            with span("repro.graph.capture"):
                cap = _Capture(self.step, args, roles, self.writeback,
                               device, thread_local=any(
                                   isinstance(x, DTensor) for x in tensors))
            self._captures[key] = cap
            self.log.append({"capture_seconds": cap.rec.capture_seconds,
                             "pool_bytes": cap.rec.pool_bytes,
                             "tensors": len(tensors)})
        with span("repro.graph.copy_in"):
            src, dst = [], []
            for f, rs, mine in zip(flat, roles, cap.args):
                for x, r, s in zip(f, rs, mine):
                    if r in (COPY, INOUT, DONATE) and x is not s:
                        src.append(_local(x))
                        dst.append(_local(s))
            if dst:
                torch._foreach_copy_(dst, src)
        with span("repro.graph.replay"):
            static = cap.rec.replay()
        with span("repro.graph.copy_out"):
            back_src, back_dst = [], []
            for f, rs, mine in zip(flat, roles, cap.args):
                for x, r, s in zip(f, rs, mine):
                    if r == INOUT and x is not s:
                        back_src.append(_local(s))
                        back_dst.append(_local(x))
            if back_dst:
                torch._foreach_copy_(back_dst, back_src)
            out = self._outputs(cap, static, flat)
        cap.rec.log_stages(self.name)
        return out

    def _outputs(self, cap: _Capture, out, flat: list):
        if not isinstance(out, tuple):
            return self._copy_out(cap, out, flat)
        return tuple(o if i in self.writeback
                     else self._copy_out(cap, o, flat)
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
