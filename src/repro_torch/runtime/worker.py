"""Worker-side execution: compute kernels, batch runner, thread workers.

This module is split along the transport seam (see
:mod:`repro_torch.runtime.transport`):

* **Compute kernels** (:func:`make_compute`) — the actual coded-task math,
  ``x.T @ y`` on host BLAS (releases the GIL) or on a CUDA device.  Pure
  functions of the operands; no knowledge of queues or processes.
* **:class:`BatchRunner`** — the backend-agnostic per-batch engine: walk a
  round slice task by task, wait out each task's injected straggler delay
  against a cancellation guard, compute, and emit a
  :class:`~repro_torch.runtime.tasks.TaskResult`.  Every backend (thread,
  process, cuda, socket) runs its tasks through this one class, so purge
  semantics and occupancy accounting cannot drift between transports.
* **:class:`Worker` / :class:`WorkerPool`** — the in-process *thread*
  transport loop: one thread per worker with a FIFO queue, shared-memory
  :class:`~repro_torch.runtime.tasks.RoundContext` cancellation, and
  deterministic drain-or-purge shutdown.  :class:`WorkerPool` implements
  the :class:`~repro_torch.runtime.transport.base.WorkerTransport` contract and
  is re-exported as the ``thread`` backend.

Each worker executes the ``kappa_p`` coded tasks the master assigned for
the round (eq. (1)).  A task is a genuine matrix product ``x.T @ y`` of
polynomial-coded blocks; heterogeneity and stragglers are injected as a
pre-task delay sampled master-side from the pluggable straggler model:

* ``"none"``  — no injected delay; tasks run as fast as the host allows.
* ``"exp"``   — delay ~ Exp(scale = complexity / mu_p), the §IV service
  model (worker p's task time for complexity c is Exp(mu_p / c)).
* ``"stall"`` — like ``"exp"`` but workers listed in ``stall_workers``
  freeze for ``stall_seconds`` per task (a dead/hogged node); redundancy
  (omega > 1) is what keeps rounds fusing without them.
* ``"shift"`` — regime change: ``"exp"`` until ``shift_at`` seconds after
  the first sample, then the ``stall_workers`` go dark (``stall_seconds``
  per task) for the rest of the run — a node failure mid-run, the
  scenario the adaptive omega controller exists for.
* ``"burst"`` — recurring outages: the ``stall_workers`` go dark for the
  first ``burst_len`` seconds of every ``burst_period``-second window,
  ``"exp"`` otherwise — a periodically hogged/GC-ing node.

The time-varying modes are wall-clock based (seconds since the model's
first sample), so every variant of a sweep — static or adaptive omega —
faces the same regime timeline against the same arrival trace.

Workers wait out the injected delay on the round's cancellation guard, so
a purge (round fused elsewhere, or job terminated) reclaims a delayed
worker immediately — matching the simulator's master-paced round
boundaries.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Protocol

import numpy as np
import torch

from repro_torch.runtime import telemetry
from repro_torch.runtime.tasks import (GroupBatch, RoundBatch, RoundContext,
                                 RuntimeConfig, TaskResult, WireBatch)
from repro_torch.runtime.transport.base import StragglerModel, WorkerTransport

__all__ = ["StragglerModel", "Worker", "WorkerPool", "BatchRunner",
           "CancelGuard", "make_compute", "clock"]

clock = time.monotonic

#: Poll granularity (seconds) for long cancellable waits.  Delays shorter
#: than one slice — the typical exp draw — are a single plain wait, so the
#: injected-delay precision the simulator-agreement tests rely on is
#: untouched; only multi-second stalls are sliced, where the slack lets a
#: stopping worker notice a pool-wide purge that bypassed its round guard.
WAIT_SLICE = 0.1


# -- compute kernels ----------------------------------------------------------

def _host_compute(x: np.ndarray, y: np.ndarray,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    # ``out`` lets a transport provide the destination buffer — the
    # process backend's shared-memory arena path computes each product
    # straight into its result slot, so the value never exists anywhere
    # else.  Same BLAS kernel either way: results are bit-identical.
    if out is None:
        return x.T @ y
    return np.matmul(x.T, y, out=out)


def _cuda_compute(device: torch.device
                  ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """``x.T @ y`` in float64 on one CUDA device, for one worker thread.

    The worker gets its own stream, so workers sharing a card overlap.
    Operands are staged through the worker's pinned host buffers (reused
    across tasks of equal shape) and copied to the device with
    ``non_blocking=True``; the matmul is enqueued behind them on the same
    stream.  The copy of the product back to the host is the only
    synchronization, right before the result is emitted to the fusion
    node — by then the staged copies have completed, so the next task
    may overwrite the staging buffers.
    """
    stream = torch.cuda.Stream(device=device)
    staging: dict[str, torch.Tensor] = {}

    def stage(slot: str, arr: np.ndarray) -> torch.Tensor:
        buf = staging.get(slot)
        if buf is None or tuple(buf.shape) != arr.shape:
            buf = staging[slot] = torch.empty(arr.shape, dtype=torch.float64,
                                              pin_memory=True)
        np.copyto(buf.numpy(), arr, casting="same_kind")
        return buf

    def compute(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        hx, hy = stage("x", x), stage("y", y)
        with torch.cuda.stream(stream):
            dx = hx.to(device, non_blocking=True)
            dy = hy.to(device, non_blocking=True)
            out = torch.matmul(dx.T, dy)
            return out.cpu().numpy()     # blocking copy: syncs the stream

    return compute


def make_compute(cfg: RuntimeConfig, worker_id: int, *,
                 device: Optional[torch.device] = None
                 ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """The coded-task kernel for one worker: host BLAS or a CUDA device.

    ``device`` pins the worker to a specific CUDA device (the ``cuda``
    backend passes ``cuda:{worker_id % device_count}``); with
    ``device=None`` the worker computes on host BLAS, which releases the
    GIL so a thread pool genuinely overlaps.
    """
    del worker_id  # reserved for per-worker kernel variants
    if device is not None:
        return _cuda_compute(device)
    return _host_compute


# -- the backend-agnostic batch engine ---------------------------------------

class CancelGuard(Protocol):
    """The cancellation primitive a transport hands the batch runner.

    ``cancelled()`` is the instantaneous probe (checked before every
    task); ``wait(delay)`` blocks for up to ``delay`` seconds and returns
    True the moment the batch is cancelled (purge, termination, or a
    purge-mode shutdown) — the hook that makes straggler reclamation
    immediate on every backend.
    """

    def cancelled(self) -> bool: ...

    def wait(self, delay: float) -> bool: ...


class BatchRunner:
    """Executes round slices for one worker, whatever the transport.

    Owns the worker's occupancy/outcome counters (``busy_seconds`` =
    injected delay + compute, including purged waits; ``tasks_done``;
    ``tasks_purged``) so the accounting is identical across backends.
    ``emit`` delivers each completed :class:`TaskResult` — directly into
    the fusion node for in-process backends, onto the result queue for
    remote ones.
    """

    def __init__(self, worker_id: int,
                 compute: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 emit: Callable[[TaskResult], None],
                 tracer: Optional[telemetry.Tracer] = None):
        self.worker_id = worker_id
        self._compute = compute
        self._emit = emit
        self._tracer = tracer
        self.busy_seconds = 0.0
        self.tasks_done = 0
        self.tasks_purged = 0

    def count_purged(self, batch: RoundBatch | WireBatch,
                     start: int = 0) -> None:
        """Account a batch tail ``[start:]`` abandoned without running.

        Transports call this for slices they drop wholesale (purge-mode
        shutdown, dead-on-arrival remote batches) so the purge counter —
        and, when tracing, the per-task ``purged`` span — stays exact on
        every backend.
        """
        self.tasks_purged += batch.count - start
        if self._tracer is not None:
            now = clock()
            for i in range(start, batch.count):
                self._tracer.emit(telemetry.TASK, now, 0.0, batch.job_id,
                                  batch.round_idx, batch.first_task_id + i,
                                  self.worker_id, 0.0, "purged")

    def run(self, batch: RoundBatch | WireBatch, guard: CancelGuard) -> None:
        """Run one round slice to completion or cancellation."""
        tr = self._tracer
        for i in range(batch.count):
            if guard.cancelled():
                self.count_purged(batch, i)
                return
            t0 = clock()
            delay = float(batch.delays[i])
            if delay > 0.0 and guard.wait(delay):
                # reclaimed mid-delay: the wait so far was real occupancy
                now = clock()
                self.busy_seconds += now - t0
                self.tasks_purged += 1
                if tr is not None:
                    tr.emit(telemetry.TASK, t0, now - t0, batch.job_id,
                            batch.round_idx, batch.first_task_id + i,
                            self.worker_id, delay, "purged")
                self.count_purged(batch, i + 1)
                return
            if guard.cancelled():
                now = clock()
                self.busy_seconds += now - t0
                self.tasks_purged += 1
                if tr is not None:
                    tr.emit(telemetry.TASK, t0, now - t0, batch.job_id,
                            batch.round_idx, batch.first_task_id + i,
                            self.worker_id, delay, "purged")
                self.count_purged(batch, i + 1)
                return
            value = self._compute(batch.x[i], batch.y[i])
            now = clock()
            self.busy_seconds += now - t0
            self.tasks_done += 1
            if tr is not None:
                tr.emit(telemetry.TASK, t0, now - t0, batch.job_id,
                        batch.round_idx, batch.first_task_id + i,
                        self.worker_id, delay, "done")
            self._emit(TaskResult(job_id=batch.job_id,
                                  round_idx=batch.round_idx,
                                  task_id=batch.first_task_id + i,
                                  worker_id=self.worker_id,
                                  value=value, finished_at=now))

    def run_group(self, batches, make_guard) -> None:
        """Run a hierarchical group's level slices in MSB-first order.

        ``make_guard(batch)`` builds each level's own cancellation guard,
        and :meth:`run` re-checks it before every sub-task — the
        between-level (in fact between-sub-task) checkpoint: a level
        purge (that level fused elsewhere) skips exactly that level's
        remaining sub-tasks while later levels still run, and a group
        purge or deadline termination cancels everything *from the next
        checkpoint on*.  Completed sub-tasks were already emitted one by
        one, so a purge never discards shipped progress — the
        hierarchical family's whole point.
        """
        for batch in batches:
            self.run(batch, make_guard(batch))

    def count_purged_any(self, batch) -> None:
        """`count_purged` that also accepts a group form — local
        :class:`GroupBatch` or wire :class:`~repro_torch.runtime.tasks.WireGroup`
        — by dropping every level."""
        levels = getattr(batch, "levels", None)
        if levels is not None:
            for b in levels:
                self.count_purged(b)
        else:
            self.count_purged(batch)


class _EventGuard:
    """Thread-backend guard: the round's shared cancel event + pool stop.

    A purge wakes the wait instantly through the event; a purge-mode
    worker stop is noticed at worst one :data:`WAIT_SLICE` later (only
    relevant for multi-second stall delays — shorter delays are a single
    un-sliced wait).
    """

    __slots__ = ("_ctx", "_worker")

    def __init__(self, ctx, worker: "Worker"):
        self._ctx = ctx
        self._worker = worker

    def cancelled(self) -> bool:
        return self._ctx.cancelled or self._worker.purging

    def wait(self, delay: float) -> bool:
        end = clock() + delay
        while True:
            remaining = end - clock()
            if remaining <= 0.0:
                return False
            if self._ctx.cancel.wait(timeout=min(remaining, WAIT_SLICE)):
                return True
            if self._worker.purging:
                return True


# -- the thread transport loop ------------------------------------------------

class Worker(threading.Thread):
    """One worker thread: FIFO queue, cancellation-aware delay, compute."""

    def __init__(self, worker_id: int,
                 sink: Callable[[TaskResult], None],
                 compute: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 tracer: Optional[telemetry.Tracer] = None):
        super().__init__(name=f"runtime-worker-{worker_id}", daemon=True)
        self.worker_id = worker_id
        self.runner = BatchRunner(worker_id, compute, sink, tracer)
        self._queue: collections.deque[RoundBatch] = collections.deque()
        self._cv = threading.Condition()
        self._stopping = False
        self._purge_on_stop = False

    @property
    def busy_seconds(self) -> float:
        return self.runner.busy_seconds

    @property
    def tasks_done(self) -> int:
        return self.runner.tasks_done

    @property
    def tasks_purged(self) -> int:
        return self.runner.tasks_purged

    @property
    def purging(self) -> bool:
        """True once a purge-mode stop was requested (drains nothing)."""
        return self._stopping and self._purge_on_stop

    def submit_round(self, batch: RoundBatch) -> None:
        """Enqueue one round's whole slice: one append, one notify."""
        with self._cv:
            self._queue.append(batch)
            self._cv.notify()

    def stop(self, *, drain: bool = False) -> None:
        """Request shutdown, deterministically.

        ``drain=True`` finishes every queued batch first (delays and all);
        ``drain=False`` (the default) *purges*: queued and in-flight
        batches are abandoned and counted in ``tasks_purged``, and an
        in-progress delay wait aborts within one :data:`WAIT_SLICE`.
        Either way the thread exits on its own — results can no longer be
        silently dropped by interpreter teardown racing a daemon thread.
        """
        with self._cv:
            self._stopping = True
            self._purge_on_stop = not drain
            self._cv.notify()

    def run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait()
                if not self._queue:
                    return          # stopping and drained
                if self.purging:    # stopping in purge mode: count + exit
                    for b in self._queue:
                        self.runner.count_purged_any(b)
                    self._queue.clear()
                    return
                batch = self._queue.popleft()
            if isinstance(batch, GroupBatch):
                self.runner.run_group(
                    batch.levels, lambda b: _EventGuard(b.ctx, self))
            else:
                self.runner.run(batch, _EventGuard(batch.ctx, self))


class WorkerPool(WorkerTransport):
    """The thread backend: ``cfg.num_workers`` worker threads + straggler
    model.

    This is the reference implementation of the
    :class:`~repro_torch.runtime.transport.base.WorkerTransport` contract (the
    ``thread`` backend re-exports it): rounds are submitted as zero-copy
    :class:`RoundBatch` views (the seq-stamp + eq. (1) slicing loop is
    the base class's; only the per-worker hop lives here), results flow
    straight into ``sink`` from the worker threads, and purges propagate
    through the shared :class:`~repro_torch.runtime.tasks.RoundContext` cancel
    event.
    """

    name = "thread"

    def __init__(self, cfg: RuntimeConfig,
                 sink: Callable[[TaskResult], None],
                 rng: Optional[np.random.Generator] = None,
                 tracer: Optional[telemetry.Tracer] = None):
        super().__init__(cfg, sink, rng, tracer)
        self.workers = [Worker(p, sink, self._compute_for(p), tracer)
                        for p in range(cfg.num_workers)]
        self._started = False
        self._shutting_down = False

    def _compute_for(self, worker_id: int):
        """Kernel factory hook; the cuda backend overrides with devices."""
        return make_compute(self._cfg, worker_id)

    def start(self) -> None:
        for w in self.workers:
            w.start()
        self._started = True

    def dead_worker_map(self) -> dict[int, str]:
        if not self._started or self._shutting_down:
            return {}
        return {w.worker_id: w.name for w in self.workers
                if not w.is_alive()}

    def _quarantine_worker(self, worker_id: int, reason: str) -> None:
        """Retire a dead worker thread: purge-count its orphaned queue so
        the task accounting stays exact, and make sure a (somehow) still-
        running thread stops instead of computing for a fleet that no
        longer includes it."""
        w = self.workers[worker_id]
        if w.is_alive():
            w.stop()         # purge mode: counts its own queue on exit
            return
        with w._cv:          # dead thread: count what it left behind
            for b in w._queue:
                w.runner.count_purged_any(b)
            w._queue.clear()

    def _send_slice(self, worker_id: int, ctx: RoundContext, first_task: int,
                    x: np.ndarray, y: np.ndarray,
                    delays: np.ndarray) -> None:
        """One zero-copy :class:`RoundBatch` (views, no per-task objects),
        one queue append, one notify."""
        self.workers[worker_id].submit_round(
            RoundBatch(ctx=ctx, first_task_id=first_task, x=x, y=y,
                       delays=delays))

    def _send_group(self, worker_id: int, seq: int,
                    entries: list[tuple]) -> None:
        """One :class:`GroupBatch` of per-level zero-copy views; the
        worker thread runs the levels in order against each level's own
        shared cancel event, so ``purge_level`` (the base default —
        ``ctx.purge()``) reclaims a fused level immediately."""
        del seq    # in-process: the live contexts carry the purge signal
        batches = tuple(
            RoundBatch(ctx=ctx, first_task_id=lo, x=x, y=y, delays=d)
            for ctx, lo, x, y, d in entries)
        self.workers[worker_id].submit_round(GroupBatch(levels=batches))

    def dispatch_round(self, ctx, X, Y, kappa, delays=None) -> None:
        """Back-compat alias (pre-transport name) for ``submit_round``."""
        self.submit_round(ctx, X, Y, kappa, delays=delays)

    def purge_round(self, ctx) -> None:
        """Purge one round: the shared cancel event reclaims every worker
        holding (or delaying on) one of its tasks immediately."""
        ctx.purge()

    def shutdown(self, timeout: float = 10.0, *, drain: bool = False
                 ) -> None:
        """Stop all workers deterministically; raise on a leaked thread.

        ``drain=False`` (default) purges outstanding batches — the master
        has already fused or terminated every round it submitted, so
        anything still queued is a straggler by definition.  ``drain=True``
        completes queued work first (delays included; may block up to the
        longest remaining injected delay).
        """
        self._shutting_down = True
        for w in self.workers:
            w.stop(drain=drain)
        leaked = []
        for w in self.workers:
            w.join(timeout=timeout)
            if w.is_alive():
                leaked.append(w.name)
        if leaked:
            raise RuntimeError(
                f"worker threads failed to stop within {timeout}s: {leaked}")

    @property
    def busy_seconds(self) -> np.ndarray:
        return np.asarray([w.busy_seconds for w in self.workers])

    @property
    def tasks_done(self) -> int:
        return sum(w.tasks_done for w in self.workers)

    @property
    def tasks_purged(self) -> int:
        return sum(w.tasks_purged for w in self.workers)
