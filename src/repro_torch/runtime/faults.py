"""Worker-loss supervision: quarantine, re-dispatch, degraded release.

The master consults a :class:`FaultSupervisor` from its fusion wait loops
instead of letting transport liveness errors propagate.  Behaviour is
selected by ``RuntimeConfig.fault_policy``:

``fail-fast`` (default)
    Today's contract, unchanged: any unexpectedly-dead worker raises
    :class:`~repro_torch.runtime.errors.TransportDeadError` out of the run.

``degrade``
    The run *survives* worker death.  On every consultation the
    supervisor

    1. offers quarantined workers a way back in
       (:meth:`WorkerTransport.try_readmit` — only the socket backend's
       reconnect path can ever succeed), re-splitting the eq. (1)
       ``kappa`` over the enlarged fleet;
    2. scans :meth:`WorkerTransport.dead_worker_map` for *new* deaths,
       quarantines each (the transport withholds all future slices and
       tears down its side of the worker), and has the
       :class:`~repro_torch.runtime.adaptive.OmegaController` re-split
       ``kappa`` over the survivors — shrinking redundancy in proportion
       to the lost service capacity, floored at ``omega = 1``
       (see :meth:`OmegaController.refit_fleet`);
    3. re-dispatches the in-flight round's *lost* tasks — every coded
       task whose current owner is quarantined, whether it was sent and
       died with the worker or withheld at submit because the round's
       buffered ``kappa`` predates the death — to survivors, with a
       bounded number of attempts per round and exponential backoff
       (jittered so repeated fleet-wide retries do not synchronize).
       Duplicate deliveries are legal: the fusion node dedupes by
       ``task_id``, so a re-dispatch racing the original worker's
       last-gasp result can never hand the Vandermonde decode a
       singular arrival set.

    The supervisor's verdict (:meth:`check` returning True) means *give
    up on the in-flight round*: either the fleet collapsed below the
    recovery threshold ``k`` (``collapsed`` — no geometry can decode;
    the master releases every in-flight and queued job promptly at its
    best-ready resolution, marked degraded) or the round exhausted its
    re-dispatch budget (the master terminates just that job, degraded,
    and keeps serving).  Never a hang, never an abort.

Everything the supervisor does is recorded twice: as telemetry events
(``QUARANTINE`` / ``READMIT`` / ``REDISPATCH``) when the run traces, and
unconditionally in :attr:`fault_log` — a list of plain dicts (``t``
seconds from run start, ``kind`` in {``quarantine``, ``readmit``,
``redispatch``, ``redispatch-exhausted``, ``fleet-collapse``,
``fleet-recovered``}, plus per-kind fields) surfaced on
:class:`~repro_torch.runtime.metrics.RuntimeResult`.
"""

from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np

from repro_torch.runtime import telemetry
from repro_torch.runtime.adaptive import OmegaController
from repro_torch.runtime.fusion import RoundFusion
from repro_torch.runtime.tasks import RoundContext, RuntimeConfig
from repro_torch.runtime.transport.base import WorkerTransport

__all__ = ["FaultSupervisor"]

clock = time.monotonic


class _TrackedRound:
    """Dispatch state of the in-flight round, as the supervisor sees it.

    ``owner`` maps every coded task index to the worker currently
    responsible for it — initialized from the round's own eq. (1)
    ``kappa`` (the split it was *encoded* with, which may predate a
    quarantine) and rewritten by each re-dispatch, so nested failures
    (a survivor dying while holding a re-dispatched slice) re-lose
    exactly the right tasks.
    """

    __slots__ = ("ctx", "X", "Y", "rf", "owner", "attempts",
                 "next_attempt", "abandoned")

    def __init__(self, ctx: RoundContext, X: np.ndarray, Y: np.ndarray,
                 kappa: np.ndarray, rf: RoundFusion):
        self.ctx = ctx
        self.X = X
        self.Y = Y
        self.rf = rf
        self.owner: dict[int, int] = {}
        lo = 0
        for p, kp in enumerate(np.asarray(kappa, dtype=np.int64)):
            for t in range(lo, lo + int(kp)):
                self.owner[t] = p
            lo += int(kp)
        self.attempts = 0
        self.next_attempt = 0.0
        self.abandoned = False

    def settled(self) -> bool:
        """True when the round no longer needs supervision."""
        return self.abandoned or self.ctx.cancelled or self.rf.wait(0.0)

    def lost_runs(self, quarantined: set[int]) -> list[tuple[int, int]]:
        """Maximal contiguous ``[lo, hi)`` runs of tasks whose owner is
        quarantined — the units a re-dispatch ships (``_send_slice``
        moves one contiguous slice of the coded buffers)."""
        lost = sorted(t for t, p in self.owner.items() if p in quarantined)
        runs: list[tuple[int, int]] = []
        for t in lost:
            if runs and runs[-1][1] == t:
                runs[-1] = (runs[-1][0], t + 1)
            else:
                runs.append((t, t + 1))
        return runs


class FaultSupervisor:
    """Master-side fault authority for one run (see module docstring)."""

    #: Re-dispatch attempts per round before the job is released degraded.
    MAX_REDISPATCH = 3
    #: Base / ceiling of the jittered exponential re-dispatch backoff (s).
    REDISPATCH_BACKOFF = 0.05
    REDISPATCH_BACKOFF_CAP = 1.0
    #: Seconds between readmission probes (socket reconnect is a dial).
    READMIT_INTERVAL = 1.0

    def __init__(self, cfg: RuntimeConfig, pool: WorkerTransport,
                 controller: OmegaController,
                 tracer: Optional[telemetry.Tracer] = None):
        self.cfg = cfg
        self.pool = pool
        self.controller = controller
        self._tracer = tracer
        self.degrade = cfg.fault_policy == "degrade"
        #: Chronological fault record (RuntimeResult.fault_log).
        self.fault_log: list[dict] = []
        #: Distinct worker deaths handled (readmission re-arms a slot).
        self.workers_lost = 0
        #: Fleet fell below k: no geometry can decode any further round.
        self.collapsed = False
        self._handled: dict[int, str] = {}
        self._round: Optional[_TrackedRound] = None
        self._next_readmit = 0.0
        self._t0 = clock()
        self._rng = random.Random(cfg.seed ^ 0xFA17)

    # -- master-facing surface ------------------------------------------------
    @property
    def wait_slice(self) -> float:
        """How often the master's fusion wait yields to :meth:`check`.

        Fail-fast keeps the historical 5 s liveness slice; degrade mode
        polls fast enough that detection -> quarantine -> re-dispatch
        costs a fraction of a round, not multiples of one.
        """
        return 0.25 if self.degrade else 5.0

    def set_origin(self, t0: float) -> None:
        """Anchor ``fault_log`` timestamps on the run start instant."""
        self._t0 = t0

    def track_round(self, ctx: RoundContext, X: np.ndarray, Y: np.ndarray,
                    kappa: np.ndarray, rf: RoundFusion) -> None:
        """Register the just-dispatched round as the supervised in-flight
        round (master calls this right after ``submit_round``)."""
        if self.degrade:
            self._round = _TrackedRound(ctx, X, Y, kappa, rf)

    def check(self) -> bool:
        """One supervision step; called from the master's wait loops.

        Returns True when the master must give up on the in-flight
        round (fleet collapse or re-dispatch budget exhausted) and
        release the job at its best-ready resolution, degraded.  Under
        ``fail-fast`` this is exactly the historical
        ``pool.assert_alive()`` (raises instead of returning True).
        """
        if not self.degrade:
            self.pool.assert_alive()
            return False
        if self.collapsed:
            # terminal for a fleet that cannot come back (thread/process
            # workers), but a socket host reconnecting can re-arm the run
            if (self._readmit(clock())
                    and self.controller.refit_fleet(
                        self.pool.active_workers)):
                self.collapsed = False
                self._log("fleet-recovered",
                          survivors=len(self.pool.active_workers))
                return False
            return True
        now = clock()
        refit = self._readmit(now)
        refit = self._quarantine_new_deaths() or refit
        if refit and not self.controller.refit_fleet(
                self.pool.active_workers):
            self.collapsed = True
            self._log("fleet-collapse",
                      survivors=len(self.pool.active_workers),
                      k=self.cfg.k)
            return True
        return self._redispatch(now)

    # -- internals ------------------------------------------------------------
    def _log(self, kind: str, **fields) -> None:
        self.fault_log.append(
            {"t": round(clock() - self._t0, 6), "kind": kind, **fields})

    def _readmit(self, now: float) -> bool:
        """Offer quarantined workers a way back; True if the fleet grew."""
        if not self.pool.quarantined or now < self._next_readmit:
            return False
        self._next_readmit = now + self.READMIT_INTERVAL
        readmitted = self.pool.try_readmit()
        for p in readmitted:
            # re-arm the death slot: a readmitted worker that dies again
            # is a NEW fault, not an already-handled one
            reason = self._handled.pop(p, "")
            self._log("readmit", worker=p, was=reason)
            if self._tracer is not None:
                self._tracer.emit(telemetry.READMIT, clock(), worker=p,
                                  label=reason)
        return bool(readmitted)

    def _quarantine_new_deaths(self) -> bool:
        """Quarantine unhandled deaths; True if the fleet shrank."""
        dead = self.pool.dead_worker_map()
        newly = {p: desc for p, desc in dead.items()
                 if p not in self._handled}
        for p, desc in sorted(newly.items()):
            self._handled[p] = desc
            self.pool.quarantine(p, desc)   # emits QUARANTINE when traced
            self.workers_lost += 1
            self._log("quarantine", worker=p, reason=desc)
        return bool(newly)

    def _redispatch(self, now: float) -> bool:
        """Re-send the in-flight round's lost tasks to survivors.

        Returns True only when the round exhausted its re-dispatch
        budget — the master's cue to release this job degraded.
        """
        r = self._round
        if r is None or r.settled():
            return False
        runs = r.lost_runs(self.pool.quarantined)
        if not runs or now < r.next_attempt:
            return False
        if r.attempts >= self.MAX_REDISPATCH:
            r.abandoned = True
            self._log("redispatch-exhausted", job=r.ctx.job_id,
                      round=r.ctx.round_idx, attempts=r.attempts,
                      tasks=sum(hi - lo for lo, hi in runs))
            return True
        r.attempts += 1
        backoff = min(self.REDISPATCH_BACKOFF_CAP,
                      self.REDISPATCH_BACKOFF * (2 ** (r.attempts - 1)))
        r.next_attempt = now + backoff * self._rng.uniform(0.5, 1.5)
        survivors = self.pool.active_workers
        for i, (lo, hi) in enumerate(runs):
            target = survivors[i % len(survivors)]
            # zero injected delays: the re-dispatch replaces work whose
            # straggler draw already happened; re-drawing would double-
            # penalize the round, and a lost slice should recover at the
            # survivor's native speed
            self.pool.resend_slice(target, r.ctx, lo, r.X[lo:hi],
                                   r.Y[lo:hi], np.zeros(hi - lo))
            for t in range(lo, hi):
                r.owner[t] = target
            self._log("redispatch", job=r.ctx.job_id,
                      round=r.ctx.round_idx, worker=target,
                      first_task=lo, tasks=hi - lo, attempt=r.attempts)
            if self._tracer is not None:
                self._tracer.emit(telemetry.REDISPATCH, clock(),
                                  job=r.ctx.job_id, round=r.ctx.round_idx,
                                  worker=target, value=float(hi - lo))
        return False
