"""The worker-transport contract every runtime backend implements.

:class:`WorkerTransport` is the seam between the master's §IV round loop
and the execution substrate.  The master speaks only this interface; the
thread and cuda-device backends (and any future remote/RPC one)
implement it.  The contract, precisely:

* ``start()`` brings up ``cfg.num_workers`` workers (threads, processes,
  or device-bound executors).  Worker ``p`` corresponds to service rate
  ``cfg.mu[p]`` — the eq. (1) split indexes workers by position.
* ``sample_round_delays(kappa)`` draws one round's injected straggler
  delays **master-side** (deterministic per seed, identical across
  backends) so every transport faces the same straggler trace.
* ``submit_round(ctx, X, Y, kappa, delays)`` dispatches one round: worker
  ``p`` receives the contiguous ``kappa_p``-slice of the ``(T, ...)``
  coded buffers.  The transport stamps ``ctx.seq`` with a monotonic
  dispatch sequence number; backends that cross a process boundary ship
  the slice as a :class:`~repro_torch.runtime.tasks.WireBatch` keyed by it.
* Results return **push-style**: each completed task is delivered to the
  ``sink`` callable (the fusion node's ``post``) as a
  :class:`~repro_torch.runtime.tasks.TaskResult`.  In-process backends call the
  sink from their worker threads; remote backends pump it from a drain
  thread that polls the transport's result channel.  The sink must
  therefore be thread-safe (the fusion node is), and ``finished_at``
  timestamps must be mutually comparable with the master's clock
  (``time.monotonic`` — system-wide on Linux, the platform the process
  backend targets).
* ``purge_round(ctx)`` reclaims the round's stragglers *immediately*:
  workers delaying on one of its tasks abort the wait, queued slices are
  dropped and counted.  Purge-then-result races are legal — the fusion
  node drops and counts stale results — but a purged round must never
  occupy a worker longer than one in-flight task.
* ``shutdown(timeout, drain=...)`` is deterministic drain-or-purge:
  ``drain=False`` (the master's default — every submitted round is
  already fused or terminated) purges outstanding work; ``drain=True``
  completes it.  Either way, *no worker thread or process may outlive the
  call* — implementations raise rather than leak.
* ``busy_seconds`` / ``tasks_done`` / ``tasks_purged`` expose per-worker
  occupancy (delay + compute, purged waits included) and task outcomes
  with identical semantics everywhere; ``busy_seconds`` feeds the
  ω-controller's utilization signal each round, so it may lag by at most
  the transport's result-return latency.

The adaptive controller's :class:`~repro_torch.runtime.adaptive.RoundObservation`
carries only scalars and small arrays (wait, stale count, margin,
utilization) measured master-side, so the retune loop is transport-
agnostic by construction — the ROADMAP's multi-host claim, enforced by
the backend-conformance suite (``tests/test_transport_conformance.py``).
"""

from __future__ import annotations

import abc
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.runtime import telemetry
from repro_torch.runtime.errors import TransportDeadError
from repro_torch.runtime.tasks import RoundContext, RuntimeConfig, TaskResult

__all__ = ["StragglerModel", "WorkerTransport"]

clock = time.monotonic


class StragglerModel:
    """Samples per-task injected delays for each worker (master-side RNG).

    Delays are in seconds.  The time-varying modes (``shift``/``burst``)
    measure elapsed time from the model's first sample; the master
    presamples each round's delays one round ahead, so a regime boundary
    lands within ~one round of its nominal wall-clock instant.

    Sampling is a *transport-level* concern but always runs master-side,
    whatever the backend: the delays travel to the workers inside the
    (wire) batch, so a thread run and a process run with the same seed
    face the same injected trace.  (Historically lived in
    :mod:`repro_torch.runtime.worker`, which still re-exports it.)
    """

    def __init__(self, cfg: RuntimeConfig, rng: np.random.Generator):
        self._cfg = cfg
        self._rng = rng
        self._origin: float | None = None

    def _elapsed(self) -> float:
        """Seconds since the first sample (the regime clock)."""
        now = clock()
        if self._origin is None:
            self._origin = now
        return now - self._origin

    def _stalled(self, worker_id: int) -> bool:
        """Is this worker dark *right now* under the configured regime?"""
        cfg = self._cfg
        if worker_id not in cfg.stall_workers:
            return False
        if cfg.straggler == "stall":
            return True
        if cfg.straggler == "shift":
            return self._elapsed() >= cfg.shift_at
        if cfg.straggler == "burst":
            return (self._elapsed() % cfg.burst_period) < cfg.burst_len
        return False

    def sample(self, worker_id: int, num_tasks: int) -> np.ndarray:
        """(num_tasks,) delays in seconds for one worker's round queue."""
        cfg = self._cfg
        if self._origin is None:
            # anchor the regime clock on the run's FIRST sample, whoever
            # it is for: a stall-listed worker can legitimately hold
            # kappa = 0 (eq. 1), and anchoring lazily inside its own
            # branch would silently delay or disable the regime change
            self._origin = clock()
        if num_tasks == 0 or cfg.straggler == "none":
            return np.zeros(num_tasks)
        if self._stalled(worker_id):
            return np.full(num_tasks, cfg.stall_seconds)
        scale = cfg.minijob_complexity / cfg.mu[worker_id]
        return self._rng.exponential(scale=scale, size=num_tasks)


class WorkerTransport(abc.ABC):
    """Abstract worker substrate: start / submit / purge / shutdown.

    Subclasses set :attr:`name` (the ``RuntimeConfig.backend`` key) and
    implement the abstract surface below; see the module docstring for
    the exact semantics each method must honour.

    The master-side half of dispatch is *shared*: delay sampling
    (:meth:`sample_round_delays`) and the seq-stamp + eq. (1) kappa-slice
    loop (:meth:`submit_round`) are implemented here once, so the
    "identical straggler trace and task split across backends" invariant
    cannot drift; backends only provide :meth:`_send_slice` — how one
    worker's contiguous slice actually reaches that worker.
    """

    #: Registry key (``RuntimeConfig.backend`` value) for this backend.
    name: str = "abstract"

    #: Wire-path accounting.  Transports that move data across a process
    #: or network boundary override this (as a property) with a dict of
    #: plain counters — frames/bytes per path, serialization-copied vs
    #: zero-copy splits; the master surfaces it as
    #: ``RuntimeResult.transport_stats``.  Purely in-process backends
    #: (thread, cuda) have no wire and leave it ``None``.
    wire_stats: Optional[dict] = None

    def __init__(self, cfg: RuntimeConfig,
                 sink: Callable[[TaskResult], None],
                 rng: Optional[np.random.Generator] = None,
                 tracer: Optional[telemetry.Tracer] = None):
        self._cfg = cfg
        self._sink = sink
        self._tracer = tracer
        self.straggler = StragglerModel(
            cfg, rng if rng is not None else np.random.default_rng(cfg.seed))
        self._seq = 0
        #: Workers removed from the active fleet by the fault supervisor
        #: (degrade policy).  A quarantined worker receives no further
        #: slices; its liveness state stays reported via
        #: :meth:`dead_worker_map` so accounting never loses the death.
        self.quarantined: set[int] = set()

    def sample_round_delays(self, kappa: np.ndarray) -> list[np.ndarray]:
        """Master-side per-worker injected-delay vectors for one round.

        Split out of :meth:`submit_round` so the master can presample the
        next round's delays off the critical path (in its encode-ahead
        slot) and dispatch with buffers alone.
        """
        return [self.straggler.sample(p, int(kappa[p]))
                for p in range(self._cfg.num_workers)]

    def submit_round(self, ctx: RoundContext, X: np.ndarray, Y: np.ndarray,
                     kappa: np.ndarray,
                     delays: Optional[list] = None) -> None:
        """Dispatch one round's T coded tasks per the eq. (1) split:
        worker p gets the contiguous ``kappa_p``-slice ``[lo, hi)`` of
        the coded buffers; the round is stamped with a monotonic dispatch
        ``seq`` first (the purge-watermark key for remote backends)."""
        if delays is None:
            delays = self.sample_round_delays(kappa)
        ctx.seq = self._seq
        self._seq += 1
        if self._tracer is not None:
            self._tracer.emit(telemetry.DISPATCH, clock(), job=ctx.job_id,
                              round=ctx.round_idx, value=float(ctx.seq))
        lo = 0
        for p in range(self._cfg.num_workers):
            hi = lo + int(kappa[p])
            if lo == hi:
                continue
            # a quarantined worker's slice is withheld, not sent into the
            # void: the fault supervisor sees the round's kappa and
            # re-dispatches exactly these tasks to survivors (a stale
            # buffered round can carry a pre-death split)
            if p not in self.quarantined:
                self._send_slice(p, ctx, lo, X[lo:hi], Y[lo:hi], delays[p])
            lo = hi

    @abc.abstractmethod
    def _send_slice(self, worker_id: int, ctx: RoundContext, first_task: int,
                    x: np.ndarray, y: np.ndarray,
                    delays: np.ndarray) -> None:
        """Deliver one worker's round slice (backend-specific hop)."""

    def submit_group(self, ctxs: list[RoundContext], Xs: list[np.ndarray],
                     Ys: list[np.ndarray], kappas: list[np.ndarray],
                     delays: Optional[list] = None) -> None:
        """Dispatch one hierarchical group: level l's codeword (plane-pair
        round ``ctxs[l].round_idx``) is sliced per its *own* eq. (1) split
        ``kappas[l]``, and each worker receives ONE group message holding
        its per-level slices in MSB-first level order.  All levels share a
        single dispatch ``seq`` (the group purge watermark); each level
        keeps its own context so fused levels purge individually
        (:meth:`purge_level`) while later levels keep computing.
        """
        if delays is None:
            delays = [self.sample_round_delays(kappa) for kappa in kappas]
        seq = self._seq
        self._seq += 1
        for ctx in ctxs:
            ctx.seq = seq
        if self._tracer is not None:
            self._tracer.emit(telemetry.DISPATCH, clock(),
                              job=ctxs[0].job_id, round=ctxs[0].round_idx,
                              value=float(seq),
                              label=f"group+{len(ctxs)}")
        for p in range(self._cfg.num_workers):
            if p in self.quarantined:
                # withheld exactly like submit_round's slices: the fault
                # supervisor re-dispatches the frontier level from kappa
                continue
            entries = []
            for l, ctx in enumerate(ctxs):
                kappa = kappas[l]
                lo = int(np.sum(kappa[:p]))
                hi = lo + int(kappa[p])
                if lo == hi:
                    continue
                entries.append((ctx, lo, Xs[l][lo:hi], Ys[l][lo:hi],
                                delays[l][p]))
            if entries:
                self._send_group(p, seq, entries)

    def _send_group(self, worker_id: int, seq: int,
                    entries: list[tuple]) -> None:
        """Deliver one worker's group of per-level slices (each entry is
        ``(ctx, first_task, x, y, delays)``).  Backends that support the
        hierarchical family override this; the config layer only admits
        ``code_family='hierarchical'`` for backends that do."""
        raise NotImplementedError(
            f"{self.name} transport does not dispatch hierarchical groups")

    def purge_level(self, ctx: RoundContext) -> None:
        """Reclaim one fused level's stragglers without cancelling the
        rest of its group.  The shared cancel event covers in-process
        backends; remote backends additionally send a level-scoped purge
        keyed by (group seq, round index)."""
        ctx.purge()

    @abc.abstractmethod
    def start(self) -> None:
        """Bring up the workers; must be called before any submit."""

    def dead_worker_map(self) -> dict[int, str]:
        """``worker_id -> description`` of unexpectedly-dead workers.

        The structured liveness report: quarantined workers stay listed
        (their death is a fact), and it is the fault supervisor's job to
        remember which deaths it already handled.  Backends override
        this; the default (no liveness tracking) reports nothing.
        """
        return {}

    def _dead_workers(self) -> list[str]:
        """Names of workers that died *unexpectedly* (not stopping)."""
        return [desc for _, desc in sorted(self.dead_worker_map().items())]

    def assert_alive(self) -> None:
        """Raise if any worker died outside an orderly shutdown.

        The master calls this between unbounded fusion waits: a worker
        process OOM-killed (or a worker thread killed by an unexpected
        exception) while holding more than ``T - k`` of a round's tasks
        would otherwise leave the round unable to fuse and the run
        blocked forever.  Turning that into a prompt
        :class:`~repro_torch.runtime.errors.TransportDeadError` is the
        ``fail-fast`` contract; backends report deaths via
        :meth:`dead_worker_map`.  Under ``fault_policy="degrade"`` the
        fault supervisor consults :meth:`dead_worker_map` directly and
        quarantines instead of calling this.
        """
        dead = self._dead_workers()
        if dead:
            raise TransportDeadError(
                f"{self.name} transport: worker(s) died mid-run: {dead}",
                workers=dead)

    # -- fault-supervision hooks (degrade policy) -----------------------------
    @property
    def active_workers(self) -> list[int]:
        """Worker ids still in the dispatch fleet (not quarantined)."""
        return [p for p in range(self._cfg.num_workers)
                if p not in self.quarantined]

    def quarantine(self, worker_id: int, reason: str) -> None:
        """Remove one dead worker from the active fleet (idempotent).

        Subsequent :meth:`submit_round` calls withhold the worker's
        slice; backends additionally tear down their side of the worker
        (:meth:`_quarantine_worker`) so a half-dead peer cannot wedge
        shutdown.
        """
        if worker_id in self.quarantined:
            return
        self.quarantined.add(worker_id)
        self._quarantine_worker(worker_id, reason)
        if self._tracer is not None:
            self._tracer.emit(telemetry.QUARANTINE, clock(),
                              worker=worker_id, label=reason)

    def _quarantine_worker(self, worker_id: int, reason: str) -> None:
        """Backend-specific quarantine teardown (default: nothing)."""

    def resend_slice(self, worker_id: int, ctx: RoundContext,
                     first_task: int, x: np.ndarray, y: np.ndarray,
                     delays: np.ndarray) -> None:
        """Re-dispatch a lost slice of an in-flight round to a survivor.

        The fault supervisor's re-dispatch hop: same delivery path as
        :meth:`submit_round`'s slices (``ctx.seq`` is already stamped),
        addressed to a surviving worker of the supervisor's choosing.
        """
        self._send_slice(worker_id, ctx, first_task, x, y, delays)

    def try_readmit(self) -> list[int]:
        """Attempt to re-establish quarantined workers; returns the ids
        readmitted (removed from quarantine).  Only backends with a
        reconnect path (socket) can ever readmit; the default is none —
        a dead thread or process does not come back.
        """
        return []

    @abc.abstractmethod
    def purge_round(self, ctx: RoundContext) -> None:
        """Reclaim the round's stragglers immediately (idempotent)."""

    @abc.abstractmethod
    def shutdown(self, timeout: float = 10.0, *, drain: bool = False
                 ) -> None:
        """Deterministic drain-or-purge stop; raises on leaked workers."""

    @property
    @abc.abstractmethod
    def busy_seconds(self) -> np.ndarray:
        """(num_workers,) seconds each worker spent occupied so far."""

    @property
    @abc.abstractmethod
    def tasks_done(self) -> int:
        """Completed (result-emitting) tasks across all workers."""

    @property
    @abc.abstractmethod
    def tasks_purged(self) -> int:
        """Tasks abandoned by purges or purge-mode shutdown."""
