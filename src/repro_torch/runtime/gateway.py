"""Multi-tenant layered serving gateway over one shared runtime fleet.

The paper's serving story, measured: many concurrent requests — each a
layered matmul job with its own deadline and an optional minimum
acceptable resolution — multiplex over a single warm worker fleet, and
every request is released to its client at its best-ready resolution the
moment its deadline fires (or earlier, on completion).  Three moving
parts:

* **Continuous admission.**  The gateway owns a
  :class:`~repro_torch.runtime.master.Master` running
  :meth:`~repro_torch.runtime.master.Master.serve_queue` on a background
  thread: submitted requests become
  :class:`~repro_torch.runtime.tasks.JobSpec` items on an open
  :class:`~repro_torch.runtime.master.JobQueue`, entering the master's
  encode-ahead pipeline between rounds — no fleet restart, one transport
  for the whole stream.

* **Queueing-bound admission control** (``admission="gg1"``).  The
  G/G/1 machinery of :mod:`repro_torch.core.queueing` (paper eqs. 2-4)
  prices a request before it is queued: estimated delay at resolution
  ``l`` is
  ``backlog + W + E[T_s] * cum(l)/m**2`` with ``W`` Marchal's waiting
  time (:func:`~repro_torch.core.queueing.gg1_waiting_time`) over measured
  arrival/service moments (modeled priors until enough samples land).
  A request whose deadline cannot cover the full-resolution estimate is
  *down-resolved* to the largest resolution that fits — its job's round
  budget is capped, so LSB rounds it would never release are never
  computed — and one that cannot even meet its minimum acceptable
  resolution is *rejected* at the door.  ``admission="none"`` admits
  everything at the requested resolution (load-generation mode).

* **Deadline-fire release.**  A background drain thread watches every
  outstanding :class:`Ticket` and finalizes it at the earlier of the
  job's release (completion or the master's §IV termination) and the
  request's own deadline — so a client is answered *at the deadline*
  even when its job is still queued behind a long service.  A request
  released below its admitted resolution is marked ``degraded``.

Per-request outcomes (decision, release resolution, slack, queue wait)
accumulate in a :class:`GatewayStats` artifact — surfaced by
``runctl serve-gateway --json`` — whose always-on event log reconciles
exactly with the counters (and is mirrored into the runtime tracer as
``request``/``admit``/``release`` events when ``cfg.trace`` is on).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.core import layering
from repro_torch.core.queueing import (Moments, gg1_waiting_time,
                                       service_rate_bound)
from repro_torch.runtime import telemetry
from repro_torch.runtime.fusion import LayeredResult
from repro_torch.runtime.master import JobQueue, Master
from repro_torch.runtime.tasks import JobSpec, RuntimeConfig
from repro_torch.runtime.worker import clock

__all__ = ["ServingGateway", "AdmissionController", "GatewayStats",
           "Ticket"]

#: measured-moment sample floor: below it the admission bound runs on the
#: modeled priors (cfg arrival rate; super-worker service bound)
MIN_SAMPLES = 8


@dataclasses.dataclass
class Ticket:
    """One request's lifecycle record (returned by
    :meth:`ServingGateway.submit`).

    All times are seconds relative to the gateway's clock origin
    (``master.t0``).  ``slack`` is ``deadline_at - released_at``:
    positive when the release beat the deadline.  ``degraded`` means the
    released resolution fell below the *admitted* one — a down-resolve
    at admission is priced, not degraded.
    """

    request_id: int
    decision: str               # admitted | down-resolved | rejected
    arrival: float
    deadline: float             # requested budget (seconds)
    deadline_at: float          # arrival + deadline
    requested_resolution: int
    admitted_resolution: int    # -1 when rejected
    min_resolution: int
    estimate: float             # admission-time delay estimate (seconds)
    service_share: float = 0.0  # this ticket's backlog contribution
    result: Optional[LayeredResult] = dataclasses.field(
        default=None, repr=False)
    released_resolution: int = -1
    released_at: Optional[float] = None
    slack: Optional[float] = None
    degraded: bool = False
    queue_wait: Optional[float] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def admitted(self) -> bool:
        return self.decision != "rejected"

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the gateway releases this request to its client."""
        return self.done.wait(timeout=timeout)

    def value(self) -> np.ndarray:
        """The released resolution's matrix (raises if nothing landed)."""
        if self.result is None or self.released_resolution < 0:
            raise RuntimeError(
                f"request {self.request_id}: no resolution released")
        return self.result.resolution(self.released_resolution)


@dataclasses.dataclass
class GatewayStats:
    """Per-request outcome counters + the authoritative event log.

    ``events`` is always on (unlike the opt-in runtime tracer, which can
    drop on ring overflow): one ``("admit", id, decision, res, t)`` per
    submit and one ``("release", id, res, degraded, t)`` per client
    release.  :meth:`reconcile` proves the counters against it exactly.
    """

    num_layers: int
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    down_resolved: int = 0
    released: int = 0
    degraded: int = 0
    release_histogram: dict = dataclasses.field(default_factory=dict)
    slacks: list = dataclasses.field(default_factory=list)
    queue_waits: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    def reconcile(self) -> None:
        """Raise ``ValueError`` unless every counter matches the event
        log exactly (valid mid-stream: released may trail admitted)."""
        admits = [e for e in self.events if e[0] == "admit"]
        releases = [e for e in self.events if e[0] == "release"]
        checks = [
            ("submitted", self.submitted, len(admits)),
            ("rejected", self.rejected,
             sum(1 for e in admits if e[2] == "rejected")),
            ("down_resolved", self.down_resolved,
             sum(1 for e in admits if e[2] == "down-resolved")),
            ("admitted", self.admitted, self.submitted - self.rejected),
            ("released", self.released, len(releases)),
            ("degraded", self.degraded,
             sum(1 for e in releases if e[3])),
            ("records", len(self.records), self.submitted),
        ]
        for name, got, want in checks:
            if got != want:
                raise ValueError(
                    f"gateway stats mismatch: {name}={got}, "
                    f"event log says {want}")
        hist: dict = {}
        for e in releases:
            hist[e[2]] = hist.get(e[2], 0) + 1
        if hist != self.release_histogram:
            raise ValueError(
                f"gateway stats mismatch: release_histogram="
                f"{self.release_histogram}, event log says {hist}")

    def deadline_success(self, resolution: int) -> float:
        """Fraction of *submitted* requests that got at least
        ``resolution`` by their deadline (a rejection counts as a miss —
        the client asked and was not served)."""
        if self.submitted == 0:
            return float("nan")
        ok = sum(1 for r in self.records
                 if (r["released_resolution"] >= resolution
                     and r["slack"] is not None and r["slack"] >= 0.0))
        return ok / self.submitted

    def to_json(self) -> dict:
        slacks = [s for s in self.slacks if s is not None]
        waits = [w for w in self.queue_waits if w is not None]
        return {
            "num_layers": self.num_layers,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "down_resolved": self.down_resolved,
            "released": self.released,
            "degraded": self.degraded,
            "release_histogram": {str(k): v for k, v
                                  in sorted(self.release_histogram.items())},
            "deadline_success": {
                str(l): self.deadline_success(l)
                for l in range(self.num_layers)},
            "mean_slack": (float(np.mean(slacks)) if slacks else None),
            "mean_queue_wait": (float(np.mean(waits)) if waits else None),
            "records": self.records,
        }


class AdmissionController:
    """Queueing-bound admission: price a request, admit/down-resolve/
    reject before it queues.

    The pure bound lives in :meth:`decide` (unit-testable against
    hand-computed G/G/1 numbers); the instance wraps it with *measured*
    arrival/service moments — sliding windows fed by the gateway,
    falling back to modeled priors (cfg arrival rate; the eq.-(3)
    super-worker service bound with exponential-like variance) until
    :data:`MIN_SAMPLES` samples land.
    """

    def __init__(self, cfg: RuntimeConfig, *, policy: str = "gg1",
                 safety: float = 1.3, window: int = 64):
        if policy not in ("gg1", "none"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.cfg = cfg
        self.policy = policy
        self.safety = float(safety)
        self._service: collections.deque = collections.deque(maxlen=window)
        self._gaps: collections.deque = collections.deque(maxlen=window)
        self._last_arrival: Optional[float] = None
        worker_means = [cfg.k * cfg.complexity / mu for mu in cfg.mu]
        prior = 1.0 / service_rate_bound(worker_means)
        self._service_prior = Moments(prior, 2.0 * prior * prior)
        lam = cfg.arrival_rate
        self._arrival_prior = Moments(1.0 / lam, 2.0 / (lam * lam))

    # -- moment tracking -----------------------------------------------------
    def note_arrival(self, t: float) -> None:
        """Record one arrival instant (monotonic seconds)."""
        if self._last_arrival is not None:
            self._gaps.append(max(t - self._last_arrival, 1e-9))
        self._last_arrival = t

    def note_service(self, seconds: float) -> None:
        """Record one measured *full-resolution-equivalent* service time
        (the gateway normalizes resolution-capped jobs by
        ``m**2 / cum(l)``)."""
        self._service.append(seconds)

    @staticmethod
    def _moments(samples, prior: Moments) -> Moments:
        if len(samples) < MIN_SAMPLES:
            return prior
        arr = np.asarray(samples, dtype=np.float64)
        return Moments(float(arr.mean()), float((arr * arr).mean()))

    def arrival_moments(self) -> Moments:
        return self._moments(self._gaps, self._arrival_prior)

    def service_moments(self) -> Moments:
        return self._moments(self._service, self._service_prior)

    # -- the bound -----------------------------------------------------------
    @staticmethod
    def decide(deadline: float, requested: int, min_resolution: int,
               backlog_seconds: float, arrival: Moments, service: Moments,
               m: int, safety: float = 1.3
               ) -> tuple[str, int, float]:
        """Price resolutions ``requested`` down to ``min_resolution``;
        admit the largest whose estimated delay fits the deadline.

        Estimated delay at resolution ``l`` is ``backlog + W +
        E[T_s] * cum(l)/m**2`` (eq. 2 with eq. 3's layered computational
        share): the work already admitted, Marchal's G/G/1 waiting time,
        and this job's own compute.  ``safety`` inflates the estimate —
        the bound is a mean, not a quantile.  Returns ``(decision,
        admitted_resolution, estimate)``; a rejection carries resolution
        ``-1`` and the floor resolution's (unaffordable) estimate.
        """
        cum = layering.cumulative_minijobs(m)
        m2 = float(m * m)
        wait = gg1_waiting_time(arrival, service)
        floor = max(min_resolution, 0)
        for l in range(requested, floor - 1, -1):
            est = backlog_seconds + wait + service.mean * (cum[l] / m2)
            if safety * est <= deadline:
                return (("admitted" if l == requested else "down-resolved"),
                        l, est)
        est = backlog_seconds + wait + service.mean * (cum[floor] / m2)
        return "rejected", -1, est

    def admit(self, deadline: float, requested: int, min_resolution: int,
              backlog_seconds: float) -> tuple[str, int, float]:
        """Decide under the current (measured-or-prior) moments."""
        arrival = self.arrival_moments()
        service = self.service_moments()
        if self.policy == "none":
            cum = layering.cumulative_minijobs(self.cfg.m)
            est = (backlog_seconds + gg1_waiting_time(arrival, service)
                   + service.mean * (cum[requested] / float(self.cfg.m ** 2)))
            return "admitted", requested, est
        return self.decide(deadline, requested, min_resolution,
                           backlog_seconds, arrival, service, self.cfg.m,
                           self.safety)


class ServingGateway:
    """Open-stream serving front-end over one shared runtime fleet.

    Usage::

        gw = ServingGateway(cfg, admission="gg1").start()
        t = gw.submit(a, b, deadline=0.05)      # returns immediately
        t.wait()                                # released by its deadline
        if t.released_resolution >= 0:
            y = t.value()
        stats = gw.stop()                       # GatewayStats artifact

    Threads: ``gateway-master`` runs
    :meth:`Master.serve_queue
    <repro_torch.runtime.master.Master.serve_queue>` over the shared
    transport; ``gateway-drain`` finalizes tickets at
    release-or-deadline.  ``submit`` may be called from any number of
    client threads.  :meth:`stop` closes admission, drains every queued
    job, joins both threads, and leaves the fleet shut down; it is
    idempotent, and ``submit`` after ``stop`` raises.
    """

    def __init__(self, cfg: RuntimeConfig, *, admission: str = "gg1",
                 safety: float = 1.3, verify: bool = False,
                 window: int = 64):
        self.cfg = cfg
        self.master = Master(cfg, verify=verify)
        self.queue = JobQueue()
        self.admission = AdmissionController(cfg, policy=admission,
                                             safety=safety, window=window)
        self.stats = GatewayStats(num_layers=cfg.num_layers)
        self._lock = threading.RLock()
        self._drain_cv = threading.Condition(self._lock)
        self._pending: dict[int, Ticket] = {}
        self._next_id = 0
        self._backlog = 0.0          # admitted-but-unreleased service est.
        self._t0: Optional[float] = None
        self._started = False
        self._stopping = False       # drain thread: finalize all + exit
        self._closed = False         # submission refused
        self._master_thread: Optional[threading.Thread] = None
        self._drain_thread: Optional[threading.Thread] = None
        self._master_error: Optional[BaseException] = None
        #: the fleet's RuntimeResult, available after :meth:`stop`
        self.result = None
        self.futures = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingGateway":
        """Start the fleet; returns self once the master clock is live."""
        if self._started:
            raise RuntimeError("gateway already started")
        self._master_thread = threading.Thread(
            target=self._master_main, name="gateway-master", daemon=True)
        self._master_thread.start()
        while not self.master.started.wait(timeout=0.1):
            if not self._master_thread.is_alive():
                raise RuntimeError(
                    "gateway master failed to start") from self._master_error
        self._t0 = self.master.t0
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="gateway-drain", daemon=True)
        self._drain_thread.start()
        self._started = True
        return self

    def _master_main(self) -> None:
        try:
            self.result, self.futures = self.master.serve_queue(self.queue)
        except BaseException as exc:   # surfaced by stop(); drain thread
            self._master_error = exc   # finalizes orphaned tickets
            self.master.started.set()

    def stop(self) -> GatewayStats:
        """Close admission, drain all queued jobs, join both threads."""
        if not self._started:
            raise RuntimeError("gateway not started")
        with self._lock:
            if self._closed:
                return self.stats      # idempotent
            self._closed = True
        self.queue.close()
        self._master_thread.join(timeout=600.0)
        if self._master_thread.is_alive():
            raise RuntimeError("gateway master failed to drain")
        with self._drain_cv:
            self._stopping = True
            self._drain_cv.notify_all()
        self._drain_thread.join(timeout=60.0)
        if self._drain_thread.is_alive():
            raise RuntimeError("gateway drain thread failed to stop")
        if self._master_error is not None:
            raise RuntimeError(
                "gateway master died mid-stream") from self._master_error
        return self.stats

    def __enter__(self) -> "ServingGateway":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        del exc
        self.stop()

    # -- client side ---------------------------------------------------------
    def submit(self, a: np.ndarray, b: np.ndarray, *, deadline: float,
               resolution: Optional[int] = None,
               min_resolution: int = 0) -> Ticket:
        """Admit one layered job ``a.T @ b``; returns its :class:`Ticket`
        immediately (``decision`` tells admitted / down-resolved /
        rejected; a rejected ticket is already ``done``).

        ``deadline`` is seconds from now — the client is answered by
        then, whatever is ready.  ``resolution`` is the requested
        (default: final) resolution; ``min_resolution`` the lowest the
        admission bound may down-resolve to AND the resolution the
        runtime guarantees to finish even past the deadline (pass ``-1``
        for pure best-effort).
        """
        if not self._started:
            raise RuntimeError("gateway not started")
        if deadline <= 0.0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        L = self.cfg.num_layers
        requested = L - 1 if resolution is None else int(resolution)
        if not 0 <= requested < L:
            raise ValueError(f"resolution {requested} not in [0, {L})")
        min_res = int(min_resolution)
        if min_res > requested:
            raise ValueError(
                f"min_resolution {min_res} > requested {requested}")
        cum = layering.cumulative_minijobs(self.cfg.m)
        with self._lock:
            if self._closed:
                raise RuntimeError("gateway is stopped")
            now = clock()
            t_rel = now - self._t0
            self.admission.note_arrival(now)
            decision, adm, est = self.admission.admit(
                deadline, requested, min_res, self._backlog)
            rid = self._next_id
            self._next_id += 1
            ticket = Ticket(
                request_id=rid, decision=decision, arrival=t_rel,
                deadline=deadline, deadline_at=t_rel + deadline,
                requested_resolution=requested, admitted_resolution=adm,
                min_resolution=min_res, estimate=est)
            self.stats.submitted += 1
            self.stats.events.append(("admit", rid, decision, adm, t_rel))
            tr = self.master.tracer
            if tr is not None:
                tr.emit(telemetry.ADMIT, now, job=rid, value=float(adm),
                        label=decision)
            if decision == "rejected":
                self.stats.rejected += 1
                self.stats.records.append(self._record(ticket))
                ticket.done.set()
                return ticket
            self.stats.admitted += 1
            if decision == "down-resolved":
                self.stats.down_resolved += 1
            lr = LayeredResult(rid, L)
            ticket.result = lr
            share = (self.admission.service_moments().mean
                     * (cum[adm] / float(self.cfg.m ** 2)))
            ticket.service_share = share
            self._backlog += share
            job = JobSpec(job_id=rid, a=np.asarray(a), b=np.asarray(b),
                          arrival=t_rel, deadline_at=t_rel + deadline,
                          min_resolution=min_res, max_resolution=adm,
                          result=lr)
            self._pending[rid] = ticket
            # register before put: once queued the master may release the
            # job at any instant, and on_release-after-release would call
            # back on THIS thread while we hold the lock (RLock makes it
            # safe, registration order makes it a non-event)
            lr.on_release(self._on_job_release)
            try:
                self.queue.put(job)
            except RuntimeError:
                self._pending.pop(rid, None)
                self._backlog -= share
                raise
            self.stats.records.append(self._record(ticket))
            return ticket

    # -- drain side ----------------------------------------------------------
    def _on_job_release(self, lr: LayeredResult) -> None:
        # master-thread callback: wake the drain, nothing else
        del lr
        with self._drain_cv:
            self._drain_cv.notify_all()

    def _drain_loop(self) -> None:
        while True:
            with self._drain_cv:
                now = clock()
                ready = [t for t in self._pending.values()
                         if (self._stopping
                             or t.result.wait_released(0.0)
                             or now >= self._t0 + t.deadline_at)]
                if not ready:
                    if self._stopping:
                        return
                    timeout = None
                    if self._pending:
                        nxt = min(self._t0 + t.deadline_at
                                  for t in self._pending.values())
                        timeout = max(nxt - now, 0.0)
                    self._drain_cv.wait(timeout=timeout)
                    continue
                for t in ready:
                    self._finalize(t)

    def _finalize(self, t: Ticket) -> None:
        """Release ticket ``t`` to its client (drain thread, under lock)."""
        lr = t.result
        now = clock()
        job_released = lr.wait_released(0.0)
        res = (lr.released_resolution if job_released
               else lr.best_resolution())
        rel_at = now - self._t0
        if job_released and lr.released_at is not None:
            # the job's own release drove this finalize: stamp ITS instant,
            # not the drain thread's wake-up latency
            rel_at = min(rel_at, lr.released_at - self._t0)
        t.released_resolution = res
        t.released_at = rel_at
        t.slack = t.deadline_at - rel_at
        t.degraded = res < t.admitted_resolution
        if lr.service_started_at is not None:
            t.queue_wait = (lr.service_started_at - self._t0) - t.arrival
            self.stats.queue_waits.append(t.queue_wait)
            if (job_released and not lr.terminated
                    and lr.released_at is not None):
                # feed the admission moments — untruncated services only,
                # normalized to full-m**2 equivalents when the job was
                # resolution-capped
                svc = lr.released_at - lr.service_started_at
                cum = layering.cumulative_minijobs(self.cfg.m)
                frac = cum[t.admitted_resolution] / float(self.cfg.m ** 2)
                if svc > 0.0 and frac > 0.0:
                    self.admission.note_service(svc / frac)
        self._backlog = max(self._backlog - t.service_share, 0.0)
        self._pending.pop(t.request_id, None)
        self.stats.released += 1
        if t.degraded:
            self.stats.degraded += 1
        self.stats.release_histogram[res] = (
            self.stats.release_histogram.get(res, 0) + 1)
        self.stats.slacks.append(t.slack)
        self.stats.events.append(
            ("release", t.request_id, res, t.degraded, rel_at))
        self._update_record(t)
        tr = self.master.tracer
        if tr is not None:
            tr.emit(telemetry.RELEASE, self._t0 + rel_at,
                    job=t.request_id, value=float(res),
                    label="degraded" if t.degraded else "ok")
            tr.emit(telemetry.REQUEST, self._t0 + t.arrival,
                    rel_at - t.arrival, job=t.request_id, value=float(res),
                    label=t.decision + ("/degraded" if t.degraded else ""))
        t.done.set()

    # -- records -------------------------------------------------------------
    @staticmethod
    def _record(t: Ticket) -> dict:
        return {
            "request_id": t.request_id, "decision": t.decision,
            "arrival": t.arrival, "deadline": t.deadline,
            "requested_resolution": t.requested_resolution,
            "admitted_resolution": t.admitted_resolution,
            "min_resolution": t.min_resolution, "estimate": t.estimate,
            "released_resolution": t.released_resolution,
            "released_at": t.released_at, "slack": t.slack,
            "degraded": t.degraded, "queue_wait": t.queue_wait,
        }

    def _update_record(self, t: Ticket) -> None:
        for r in self.stats.records:
            if r["request_id"] == t.request_id:
                r.update(self._record(t))
                return
