"""Any-``k``-of-``n`` fusion node and the per-job layered-result future.

The fusion node holds the current round's buffer: as soon as any ``k`` of
the round's ``T`` coded task results land it signals the master, which
decodes (Vandermonde solve, :meth:`PolynomialCode.decode`) and purges the
round's stragglers.  Late results from a purged round are dropped and
counted (``stale_results``) — the runtime analogue of the simulator
sampling round durations as the k-th order statistic.

:meth:`FusionNode.post` is the transport-facing sink: in-process backends
call it straight from their worker threads, remote backends from the
transport's result drain thread.  It is safe from any number of posting
threads concurrently with the master's ``begin_round``; a result's round
identity is checked against the current round *and* its (master-side)
cancel event, so a purge is effective even before the remote worker has
seen the purge message.

:class:`LayeredResult` is the job's progressive future: a consumer can
block on *any* resolution independently (``wait_resolution``), read the
best resolution available right now (``best_resolution``), or wait for the
job's release (finish or deadline termination).  Per Definition 1,
resolution ``l`` becomes ready the moment its last mini-job fuses —
MSB-first, so resolution 0 is ready after a single round.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core import coding
from repro_torch.runtime import telemetry
from repro_torch.runtime.errors import FusionStateError
from repro_torch.runtime.tasks import RoundContext, TaskResult

__all__ = ["RoundFusion", "FusionNode", "LayeredResult"]


class RoundFusion:
    """Collects one round's task results; fuses at the k-th arrival."""

    def __init__(self, ctx: RoundContext, k: int,
                 tracer: Optional[telemetry.Tracer] = None):
        self.ctx = ctx
        self.k = k
        self._lock = threading.Lock()
        self._fused = threading.Event()
        self._ids: list[int] = []
        self._id_set: set[int] = set()
        self._values: list[np.ndarray] = []
        self._tracer = tracer
        self.fused_at: Optional[float] = None

    def post(self, result: TaskResult) -> bool:
        """Deliver one task result; returns False if stale (late/purged).

        Duplicate ``task_id`` deliveries are rejected as stale: a fault-
        supervised re-dispatch can race the original worker's last-gasp
        result, and fusing the same codeword index twice would hand the
        Vandermonde decode a singular arrival set.
        """
        fused_now = False
        with self._lock:
            if self._fused.is_set() or self.ctx.cancelled:
                return False
            if result.task_id in self._id_set:
                return False
            self._id_set.add(result.task_id)
            self._ids.append(result.task_id)
            self._values.append(result.value)
            if len(self._ids) == self.k:
                self.fused_at = result.finished_at
                fused_now = True
                self._fused.set()
        tr = self._tracer
        if tr is not None:
            tr.emit(telemetry.RESULT, result.finished_at,
                    job=result.job_id, round=result.round_idx,
                    task=result.task_id, worker=result.worker_id)
            if fused_now:
                tr.emit(telemetry.FUSED, result.finished_at,
                        job=result.job_id, round=result.round_idx,
                        value=float(self.k))
        return True

    def wait(self, timeout: Optional[float]) -> bool:
        """Block until k results landed; False on timeout (deadline)."""
        return self._fused.wait(timeout=timeout)

    def decode(self, code: coding.PolynomialCode) -> np.ndarray:
        """Reconstruct the round's mini-job product from the k results."""
        if not self._fused.is_set():
            raise FusionStateError("round has not fused yet")
        return np.asarray(code.decode(self._ids, np.stack(self._values)))


class FusionNode:
    """Routes worker results to the live round(s); drops stale ones.

    Two routing regimes share one sink:

    * **Task-granular** (polynomial family): :meth:`begin_round` installs
      a single current round; anything else is stale.
    * **Sub-task-granular** (hierarchical family): :meth:`begin_group`
      installs a whole group of level rounds at once, keyed by
      ``(job_id, round_idx)``.  A result for *any* open level is
      accepted — including levels beyond the one the master is currently
      waiting on (:meth:`set_frontier`) — so straggler work on deeper
      levels is banked, never discarded.  Those banked acceptances are
      the **salvage ledger**: ``subtask_results`` counts every accepted
      grouped result, ``salvaged_subtasks`` the subset that landed ahead
      of the master's wait frontier.

    Staleness accounting is exact in both regimes: a result is counted
    stale at most once, at the single point it is rejected — whether it
    is late for a purged level, a duplicate ``task_id`` (a purged
    worker's last-gasp sub-task racing a re-dispatch), or arrives after
    :meth:`end_group` closed its group.
    """

    def __init__(self, tracer: Optional[telemetry.Tracer] = None):
        self._lock = threading.Lock()
        self._current: Optional[RoundFusion] = None
        self._group: dict[tuple[int, int], RoundFusion] = {}
        self._frontier = -1
        self._tracer = tracer
        self.stale_results = 0
        self.subtask_results = 0
        self.salvaged_subtasks = 0

    def begin_round(self, ctx: RoundContext, k: int) -> RoundFusion:
        rf = RoundFusion(ctx, k, self._tracer)
        with self._lock:
            self._current = rf
        return rf

    def begin_group(self, ctxs: list[RoundContext],
                    k: int) -> list[RoundFusion]:
        """Open one fusion per level round of a hierarchical group.

        All level rounds accept results concurrently until
        :meth:`end_group`; the wait frontier starts below every round so
        the first :meth:`set_frontier` defines it.
        """
        rfs = [RoundFusion(ctx, k, self._tracer) for ctx in ctxs]
        with self._lock:
            self._current = None
            self._group = {(rf.ctx.job_id, rf.ctx.round_idx): rf
                           for rf in rfs}
            self._frontier = -1
        return rfs

    def set_frontier(self, round_idx: int) -> None:
        """Declare the round the master is about to wait on: any accepted
        result for a *deeper* round is salvaged straggler work."""
        with self._lock:
            self._frontier = round_idx

    def end_group(self) -> None:
        """Close the open group; late results for it become stale."""
        with self._lock:
            self._group = {}
            self._frontier = -1

    def post(self, result: TaskResult) -> bool:
        """Route one result; returns True iff it was accepted.

        The verdict is the round's dedupe/staleness decision (late,
        purged, or duplicate ``task_id`` -> False), and it is the *only*
        point that decides whether a result's value will ever be read
        again: an accepted value is copied out at decode
        (:meth:`RoundFusion.decode` stacks), a rejected one is never
        dereferenced.  Transports with zero-copy result buffers key their
        slot accounting on this verdict — a rejected arena view pins
        nothing, so its slot is reclaimable the moment the purge
        watermark passes it.
        """
        with self._lock:
            rf = self._group.get((result.job_id, result.round_idx))
            grouped = rf is not None
            if rf is None:
                rf = self._current
            frontier = self._frontier
        if (rf is None
                or rf.ctx.job_id != result.job_id
                or rf.ctx.round_idx != result.round_idx
                or not rf.post(result)):
            with self._lock:
                self.stale_results += 1
            if self._tracer is not None:
                self._tracer.emit(telemetry.STALE, result.finished_at,
                                  job=result.job_id, round=result.round_idx,
                                  task=result.task_id,
                                  worker=result.worker_id)
            return False
        if grouped:
            with self._lock:
                self.subtask_results += 1
                if result.round_idx > frontier:
                    self.salvaged_subtasks += 1
        return True


class LayeredResult:
    """Future-like progressive result of one job (L resolutions).

    The runtime realization of Definition 1 + the §IV release rule:
    ``resolution(l)`` / ``wait_resolution(l)`` expose per-resolution
    readiness (resolution ``l`` is ready the moment its last mini-job
    decodes, MSB-first, so resolution 0 is ready after one round);
    ``released`` fires at job end (all rounds done, or §IV deadline
    termination) with ``released_resolution`` the highest completed layer
    (-1 if even resolution 0 was cut off).

    Threading: the producer is the master thread (``mark_resolution`` /
    ``release``); any number of consumer threads may concurrently wait on
    or read resolutions.  Each per-layer value is stored *before* its
    event is set, so an observed-set event is the happens-before edge
    that makes the read safe — consumers must go through the accessors,
    which enforce it.  Timestamps (``ready_at``) are seconds on the
    runtime's monotonic clock, the round's ``fused_at`` k-th-arrival
    instant (simulator order-statistic semantics, not the decode time).
    """

    def __init__(self, job_id: int, num_layers: int):
        self.job_id = job_id
        self.num_layers = num_layers
        self._events = [threading.Event() for _ in range(num_layers)]
        self._values: list[Optional[np.ndarray]] = [None] * num_layers
        self._ready_at: list[Optional[float]] = [None] * num_layers
        self._released = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: list = []
        self.released_resolution: int = -1
        self.terminated = False
        #: Monotonic instant service started (master sets it; None while
        #: the job is still queued).  With the job's ``arrival`` this is
        #: the measured queue wait — the number the gateway's admission
        #: bound is checked against.
        self.service_started_at: Optional[float] = None
        #: Monotonic release instant (set by :meth:`release`).
        self.released_at: Optional[float] = None

    # -- producer side (master) ---------------------------------------------
    def mark_started(self, t: float) -> None:
        """Record the service-start instant (master thread only)."""
        self.service_started_at = t

    def mark_resolution(self, l: int, value: np.ndarray, t: float) -> None:
        """Publish resolution ``l`` (master thread only).

        ``t`` is the round's ``fused_at`` instant in monotonic seconds.
        Value first, then event: the event IS the publication barrier.
        """
        self._values[l] = value
        self._ready_at[l] = t
        self._events[l].set()

    def release(self, *, terminated: bool) -> None:
        """End the job (§IV finish or termination); master thread only."""
        self.terminated = terminated
        self.released_resolution = self.best_resolution()
        self.released_at = time.monotonic()
        self._released.set()
        with self._cb_lock:
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)

    def on_release(self, fn) -> None:
        """Register ``fn(self)`` to run at release (any thread).

        Runs immediately if the job already released — registration can
        never miss the edge.  Callbacks fire on the *releasing* thread
        (the master loop), so they must be cheap and non-blocking: the
        gateway's drain thread uses one to wake its condition variable,
        nothing more.
        """
        with self._cb_lock:
            if not self._released.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- consumer side -------------------------------------------------------
    def resolution_ready(self, l: int) -> bool:
        """Non-blocking readiness probe; safe from any thread."""
        return self._events[l].is_set()

    def wait_resolution(self, l: int,
                        timeout: Optional[float] = None) -> bool:
        """Block until resolution ``l`` is ready; ``timeout`` in seconds
        (None = wait forever).  Returns False on timeout."""
        return self._events[l].wait(timeout=timeout)

    def resolution(self, l: int) -> np.ndarray:
        # read strictly under the ready event: mark_resolution stores the
        # value *before* setting the event, so a set event is the happens-
        # before edge that makes the read safe against the publisher.
        if not self._events[l].is_set():
            raise FusionStateError(f"resolution {l} not ready")
        return self._values[l]

    def ready_at(self, l: int) -> Optional[float]:
        """Monotonic-seconds instant resolution ``l`` fused (None if not
        ready) — the delay-table timestamp."""
        return self._ready_at[l]

    def best_resolution(self) -> int:
        """Highest ready resolution index, or -1 if none.

        Scans from the top: layers publish MSB-first, so the first set
        event from the top IS the answer — O(1) once any high layer is
        ready, instead of a full O(L) walk.
        """
        for l in range(self.num_layers - 1, -1, -1):
            if self._events[l].is_set():
                return l
        return -1

    def wait_released(self, timeout: Optional[float] = None) -> bool:
        """Block until the job ends (finish or §IV termination);
        ``timeout`` in seconds.  Returns False on timeout."""
        return self._released.wait(timeout=timeout)

    def result(self) -> np.ndarray:
        """The released (or current best) resolution's value."""
        best = self.best_resolution()
        if best < 0:
            raise FusionStateError(
                f"job {self.job_id}: no resolution completed")
        return self.resolution(best)   # event-guarded read
