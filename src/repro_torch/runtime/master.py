"""The master node: queue, dispatch, purge, terminate, release (§IV).

A measured, genuinely-concurrent execution of the system the simulator
models: jobs arrive (Poisson or trace), are served FIFO one at a time
(the paper's single-master discipline), and each job's ``m**2`` coded
mini-job rounds run MSB-first on an abstract
:class:`~repro_torch.runtime.transport.base.WorkerTransport` — host thread
workers, multiprocessing workers, CUDA-device workers or TCP worker hosts,
selected by ``RuntimeConfig.backend``; the loop below is identical over
all of them:

1. service start — operands are quantized (floats) and digit-decomposed;
2. per round, the mini-job's plane pair is polynomial-encoded
   (:class:`~repro_torch.core.coding.PolynomialCode`) and its ``T`` coded tasks
   are dispatched per the eq. (1) ``kappa`` split;
3. the fusion node decodes at the k-th arrival and the master *purges*
   the round's stragglers (their cancel event reclaims them instantly);
4. each completed layer is published MSB-first on the job's
   :class:`~repro_torch.runtime.fusion.LayeredResult`;
5. the §IV rule terminates a job at
   ``t_term = max(service_start + deadline, next_arrival)`` — termination
   requires BOTH deadline excess AND a queued successor — releasing the
   highest completed resolution.

Jobs reach the loop through one of two *sources* sharing the identical
service path: :meth:`Master.run` replays a fixed arrival trace (the
historical mode — the full job list is known up front and arrivals are
slept out on the master clock), while :meth:`Master.serve_queue` drains
an open :class:`JobQueue` that other threads feed *while the loop runs* —
continuous admission over one warm fleet, the serving-gateway substrate
(:mod:`repro_torch.runtime.gateway`).  Queued jobs
carry their own absolute
deadline (:attr:`~repro_torch.runtime.tasks.JobSpec.deadline_at`, an
unconditional release instant), an optional guaranteed minimum
resolution the deadline may not cut, and an optional resolution cap
that bounds the round budget (an admission down-resolve never computes
LSB rounds it won't release).

The per-round loop is *software-pipelined* so the master's own work hides
behind the in-flight round's worker compute instead of serializing with
it: round ``r``'s codeword is double-buffered and dispatched, then —
while the workers chew on it — the master decodes round ``r-1``
(publishing any completed layer), encodes round ``r+1`` into the spare
buffer, and, on a job's final round, digit-decomposes the next *queued*
job's operands.  Purge safety is preserved because each round still owns
its private :class:`RoundContext`; the §IV termination check still gates
every dispatch; and decode itself rides on the code's cached
:class:`~repro_torch.core.coding.DecodePlan` (LRU of per-arrival-set solve
operators), so the steady-state critical path per round is dispatch +
fusion wait.  Per-stage wall time is accounted in
``RuntimeResult.stage_seconds``.

Redundancy is controlled *online*: after every round the master feeds the
:class:`~repro_torch.runtime.adaptive.OmegaController` a
:class:`~repro_torch.runtime.adaptive.RoundObservation` (fusion wait, stale
count, deadline margin, utilization) and subsequent encodes pick up any
retuned ``(code, kappa)`` — see :mod:`repro_torch.runtime.adaptive` and
``docs/adaptive-omega.md``.  With the default ``cfg.adapt = "fixed"`` the
geometry never moves and the loop is the paper's static-ω system.

With ``verify=True`` every published resolution is checked against the
exact layered oracle (``layering.layered_matmul_reference``, the same
oracle the CUDA kernel in ``repro_torch.kernels.layered_matmul`` is tested
against), so a measured run is decode-verified end-to-end.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import coding, layering
from repro_torch.runtime import metrics, telemetry
from repro_torch.runtime.adaptive import OmegaController, RoundObservation
from repro_torch.runtime.faults import FaultSupervisor
from repro_torch.runtime.fusion import FusionNode, LayeredResult
from repro_torch.runtime.tasks import JobSpec, RoundContext, RuntimeConfig
from repro_torch.runtime.transport import make_transport
from repro_torch.runtime.worker import clock

__all__ = ["JobQueue", "Master", "make_jobs", "run_jobs"]


def _host_f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device="cpu").to(torch.float32)


def make_jobs(cfg: RuntimeConfig, num_jobs: int, *, K: int = 64, M: int = 8,
              N: int = 8, rng: Optional[np.random.Generator] = None,
              arrivals: Optional[Sequence[float]] = None) -> list[JobSpec]:
    """Random integer-matrix jobs with Poisson (or trace) arrivals.

    Operand magnitudes stay well inside ``m * d`` bits so float-mode decode
    is tight; ``M``/``N`` must be divisible by ``n1``/``n2``.
    """
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    if arrivals is None:
        arrivals = np.cumsum(
            rng.exponential(1.0 / cfg.arrival_rate, size=num_jobs))
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if len(arrivals) != num_jobs:
        raise ValueError(f"{len(arrivals)} arrivals for {num_jobs} jobs")
    lim = 1 << (cfg.m * cfg.d - 2)
    return [JobSpec(job_id=j,
                    a=rng.integers(-lim, lim, size=(K, M), dtype=np.int64),
                    b=rng.integers(-lim, lim, size=(K, N), dtype=np.int64),
                    arrival=float(arrivals[j]))
            for j in range(num_jobs)]


class JobQueue:
    """Thread-safe open job queue feeding :meth:`Master.serve_queue`.

    Producers (any thread — the serving gateway's submit path) ``put``
    :class:`~repro_torch.runtime.tasks.JobSpec` items; the master consumes
    them FIFO.  :meth:`close` ends admission: the master drains whatever
    is still queued and returns.  A ``put`` after ``close`` raises — the
    caller must surface it as a rejected request, never a silent drop.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._closed = False

    def put(self, job: JobSpec) -> None:
        """Enqueue one job; raises ``RuntimeError`` once closed."""
        with self._cv:
            if self._closed:
                raise RuntimeError("JobQueue is closed")
            self._items.append(job)
            self._cv.notify_all()

    def close(self) -> None:
        """End admission (idempotent); wakes a blocked consumer."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    # -- consumer side (the master's _QueueSource) ---------------------------
    def _next(self) -> Optional[JobSpec]:
        """Pop the next job, blocking until one arrives; ``None`` once
        closed and drained."""
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait()
            return self._items.popleft() if self._items else None

    def _peek(self) -> Optional[JobSpec]:
        """The next queued job without consuming it (``None`` if empty)."""
        with self._cv:
            return self._items[0] if self._items else None


class _TraceSource:
    """Replays a fixed arrival trace — the legacy :meth:`Master.run`
    semantics: sleep out each arrival, and expose the next trace arrival
    as the §IV queued-successor signal."""

    def __init__(self, jobs: Sequence[JobSpec]):
        self.jobs = list(jobs)
        self._i = 0
        self._t0 = 0.0

    def bind(self, t0: float) -> None:
        self._t0 = t0

    def next(self) -> Optional[JobSpec]:
        if self._i >= len(self.jobs):
            return None
        job = self.jobs[self._i]
        self._i += 1
        return job

    def wait_arrival(self, job: JobSpec) -> None:
        wait = (self._t0 + job.arrival) - clock()
        if wait > 0:           # idle until the job actually arrives
            time.sleep(wait)

    def peek_ready(self) -> Optional[JobSpec]:
        """The next job, only once its arrival instant has passed —
        the encode-ahead prep must not front-run the arrival process."""
        i = self._i
        if (i < len(self.jobs)
                and clock() >= self._t0 + self.jobs[i].arrival):
            return self.jobs[i]
        return None

    def successor_hint(self) -> Optional[float]:
        """Absolute arrival instant of the queued successor (§IV)."""
        i = self._i
        if i < len(self.jobs):
            return self._t0 + self.jobs[i].arrival
        return None


class _QueueSource:
    """Drains an open :class:`JobQueue` — continuous admission.

    A queued job has, by construction, already arrived (the producer
    stamped ``JobSpec.arrival`` at submit time), so ``wait_arrival`` is a
    no-op; and with no trace there is no next-arrival signal, so
    ``cfg.deadline`` alone never terminates a queued job — per-job
    deadlines travel on ``JobSpec.deadline_at`` instead."""

    def __init__(self, queue: JobQueue):
        self.queue = queue

    def bind(self, t0: float) -> None:
        del t0

    def next(self) -> Optional[JobSpec]:
        return self.queue._next()

    def wait_arrival(self, job: JobSpec) -> None:
        del job

    def peek_ready(self) -> Optional[JobSpec]:
        return self.queue._peek()

    def successor_hint(self) -> Optional[float]:
        return None


class Master:
    """Event loop owning the worker transport, fusion node, and
    ω-controller.

    Single-threaded loop: :meth:`run` (fixed trace) or
    :meth:`serve_queue` (open queue) is meant to be called once, from one
    thread — it starts the configured worker transport (``cfg.backend``:
    thread / process / cuda / socket, via
    :func:`repro_torch.runtime.transport.make_transport`), blocks until every
    job is served, and shuts the transport down (purge-mode: every
    submitted round is already fused or terminated by then).  The
    cross-thread surfaces are the
    :class:`~repro_torch.runtime.fusion.LayeredResult` futures it returns
    (consumable concurrently while the run progresses), the fusion
    node's result sink (remote transports pump it from a drain thread),
    and — in queue mode — the :class:`JobQueue` itself plus the
    :attr:`started` event / :attr:`t0` origin that producers use to put
    their timestamps on the master's clock.  All reported times are
    seconds (``time.monotonic`` deltas from the run start).

    The code geometry is owned by an
    :class:`~repro_torch.runtime.adaptive.OmegaController` (``cfg.adapt`` picks
    the policy; the default ``"fixed"`` reproduces the paper's static-ω
    §IV system exactly): after every round the master feeds it a
    :class:`~repro_torch.runtime.adaptive.RoundObservation` and subsequent
    encodes pick up any retuned ``(code, kappa)``.
    """

    def __init__(self, cfg: RuntimeConfig, *, verify: bool = False):
        self.cfg = cfg
        self.verify = verify
        # telemetry is opt-in (cfg.trace) and free when off: the tracer is
        # None and every call site below guards on it — no event objects
        # are ever built on the untraced path
        self.tracer = telemetry.Tracer() if cfg.trace else None
        self.fusion = FusionNode(tracer=self.tracer)
        self.controller = OmegaController(cfg)
        #: eq. (1) splits cached per ``(T, active)`` for the hierarchical
        #: family: level lengths repeat every group, and the optimization
        #: behind :meth:`RuntimeConfig.load_split` is ms-scale — paying it
        #: per level would dwarf a whole round's fuse time.  (The flat
        #: family's split is cached the same way, as ``controller.kappa``.)
        self._hier_kappas: dict = {}
        #: Monotonic origin of the serve loop — valid once :attr:`started`
        #: is set.  Queue-mode producers stamp ``JobSpec.arrival`` /
        #: ``deadline_at`` as offsets from this instant.
        self.t0: Optional[float] = None
        #: Set just before the first job is consumed (fleet started,
        #: warmup done, :attr:`t0` valid).
        self.started = threading.Event()

    # -- operand preparation -------------------------------------------------
    def _prepare(self, job: JobSpec):
        """Quantize float operands, digit-decompose both into m planes."""
        cfg = self.cfg
        bits = cfg.m * cfg.d
        # floats are quantized in float32 on the host: the precision the
        # JAX reference quantizes in by default, so both give the same q
        if np.issubdtype(np.asarray(job.a).dtype, np.floating):
            qa, sa = layering.quantize(_host_f32(job.a), bits)
            qa, sa = qa.numpy().astype(np.int64), float(sa)
        else:
            qa, sa = np.asarray(job.a, np.int64), 1.0
        if np.issubdtype(np.asarray(job.b).dtype, np.floating):
            qb, sb = layering.quantize(_host_f32(job.b), bits)
            qb, sb = qb.numpy().astype(np.int64), float(sb)
        else:
            qb, sb = np.asarray(job.b, np.int64), 1.0
        ca = layering._np_decompose(qa, cfg.m, cfg.d)   # (m, K, M)
        cb = layering._np_decompose(qb, cfg.m, cfg.d)   # (m, K, N)
        return qa, qb, sa * sb, ca, cb

    def _warmup(self, job: JobSpec) -> None:
        """Run one encode/compute/decode off the clock (BLAS/cache warm)."""
        code = self.controller.code
        _, _, _, ca, cb = self._prepare(job)
        X = code.encode_a(np.asarray(ca[0], np.float64))
        Y = code.encode_b(np.asarray(cb[0], np.float64))
        code.decode(list(range(code.k)),
                    np.stack([X[t].T @ Y[t] for t in range(code.k)]))

    def _warmup_job(self) -> JobSpec:
        """A tiny synthetic job for off-the-clock warmup — queue mode,
        where no real job is known before the fleet starts."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        lim = min(1 << (cfg.m * cfg.d - 2), 1 << 16)
        return JobSpec(
            job_id=-1,
            a=rng.integers(-lim, lim, size=(16, 2 * cfg.n1), dtype=np.int64),
            b=rng.integers(-lim, lim, size=(16, 2 * cfg.n2), dtype=np.int64))

    # -- hierarchical (sub-task-granular) service ------------------------------
    def _serve_hier_job(self, job, lr, prep, pool, sup, t_term, R_job,
                        guaranteed, stage, global_round, prev_stale):
        """Serve one job with the hierarchical code family.

        Rounds are dispatched in *groups* of up to ``cfg.levels``
        consecutive MSB-first mini-jobs, each level its own coded round
        under one :class:`~repro_torch.core.coding.HierarchicalCode` (per-level
        MDS rates, MSB-heavy at the controller's current aggregate
        budget).  Every worker receives its slices of the whole group in
        one message and flows through the levels in order, so while the
        master waits on the frontier level, results for deeper levels
        bank in the fusion group — straggler work is never discarded,
        only the *specific level* that fused is purged
        (:meth:`WorkerTransport.purge_level`).  A deadline or fault that
        cuts the job mid-group still ships every level that completed —
        the §IV release happens at the best level-complete resolution.

        Returns ``(term, faulted, rounds_timed, global_round,
        prev_stale)`` so the caller's shared release tail and controller
        bookkeeping continue unchanged.
        """
        cfg = self.cfg
        ctrl = self.controller
        tr = self.tracer
        t0 = self.t0
        qa, qb, scale, ca, cb = prep
        order = layering.all_minijobs_msb_first(cfg.m)
        cum = layering.cumulative_minijobs(cfg.m)
        acc = np.zeros((qa.shape[1], qb.shape[1]), dtype=np.float64)
        # per-side coded planes keyed by (T, plane): level lengths vary
        # across the group (MSB-heavy), so each length caches separately
        enc_a: dict[tuple[int, int], np.ndarray] = {}
        enc_b: dict[tuple[int, int], np.ndarray] = {}
        n_ret = len(ctrl.trace)
        timed = 0
        term = False
        faulted = False
        ridx0 = 0
        while ridx0 < R_job and not term:
            g_end = min(ridx0 + cfg.levels, R_job)
            rounds = order[ridx0:g_end]
            G = len(rounds)
            if sup.check():
                faulted = term = True
                break
            if (t_term is not None and ridx0 >= guaranteed
                    and clock() >= t_term):
                term = True      # don't dispatch a dead group
                break
            # the group's code picks up the controller's current geometry
            # (ω retune / fleet refit): per-level lengths are re-derived
            # from ctrl.omega and the split from ctrl.active every group
            hc = coding.HierarchicalCode(n1=cfg.n1, n2=cfg.n2, levels=G,
                                         omega=ctrl.omega, mode="float")
            ts = clock()
            ctxs: list[RoundContext] = []
            Xs, Ys, kappas, codes = [], [], [], []
            for lvl in range(G):
                lcode = hc.level_code(lvl)
                T = lcode.num_tasks
                _, pi, pj = rounds[lvl]
                Xa = enc_a.get((T, pi))
                if Xa is None:
                    Xa = enc_a[(T, pi)] = lcode.encode_a(
                        np.asarray(ca[pi], np.float64))
                Yb = enc_b.get((T, pj))
                if Yb is None:
                    Yb = enc_b[(T, pj)] = lcode.encode_b(
                        np.asarray(cb[pj], np.float64))
                ctxs.append(RoundContext(job.job_id, ridx0 + lvl))
                Xs.append(Xa)
                Ys.append(Yb)
                kappa = self._hier_kappas.get((T, ctrl.active))
                if kappa is None:
                    kappa = self._hier_kappas[(T, ctrl.active)] = \
                        cfg.load_split(total=T, active=ctrl.active)
                kappas.append(kappa)
                codes.append(lcode)
            te = clock()
            stage["encode"] += te - ts
            if tr is not None:
                tr.emit(telemetry.ENCODE, ts, te - ts, job=job.job_id,
                        round=ridx0)
            rfs = self.fusion.begin_group(ctxs, cfg.k)
            ts = t_disp = clock()
            pool.submit_group(ctxs, Xs, Ys, kappas)
            stage["dispatch"] += clock() - ts
            timed += G
            # frontier walk: wait the levels out MSB-first; any result
            # landing beyond the frontier banks as salvaged sub-task work
            for lvl in range(G):
                ridx = ridx0 + lvl
                l, pi, pj = rounds[lvl]
                rf = rfs[lvl]
                ctx = ctxs[lvl]
                self.fusion.set_frontier(ridx)
                # frontier level is the one a worker death re-dispatches
                sup.track_round(ctx, Xs[lvl], Ys[lvl], kappas[lvl], rf)
                global_round += 1
                ts = clock()
                if t_term is None or ridx < guaranteed:
                    while not (fused := rf.wait(sup.wait_slice)):
                        if sup.check():
                            faulted = True
                            break
                else:
                    while True:
                        remaining = t_term - clock()
                        if remaining <= 0.0:
                            fused = rf.wait(0.0)
                            break
                        if (fused := rf.wait(min(remaining,
                                                 sup.wait_slice))):
                            break
                        if sup.check():
                            faulted = True
                            break
                if faulted and rf.wait(0.0):
                    # fused in the window between the wait slice timing
                    # out and the supervisor giving up — never discarded
                    fused, faulted = True, False
                tw = clock()
                stage["wait"] += tw - ts
                if tr is not None:
                    tr.emit(telemetry.ROUND, t_disp, tw - t_disp,
                            job=job.job_id, round=ridx,
                            label="fused" if fused else "purged")
                if fused:
                    # purge only THIS level's stragglers: deeper levels
                    # of the group stay live on every worker
                    pool.purge_level(ctx)
                    td = clock()
                    mini = rf.decode(codes[lvl])
                    tp = clock()
                    stage["decode"] += tp - td
                    acc[...] += mini * float(1 << ((pi + pj) * cfg.d))
                    published = ridx + 1 == cum[l]
                    if published:
                        lr.mark_resolution(l, acc * scale, rf.fused_at)
                    stage["publish"] += clock() - tp
                    if tr is not None:
                        tr.emit(telemetry.DECODE, td, tp - td,
                                job=job.job_id, round=ridx)
                        if published:
                            tr.emit(telemetry.RESOLUTION, rf.fused_at,
                                    job=job.job_id, round=ridx,
                                    value=float(l), label=f"res{l}")
                tc = clock()
                stale_now = self.fusion.stale_results
                ctrl.observe(RoundObservation(
                    round_idx=global_round - 1, job_id=job.job_id,
                    wait=tw - ts, fused=bool(fused),
                    stale=stale_now - prev_stale,
                    deadline_margin=(None if t_term is None
                                     else t_term - tw),
                    rounds_left=R_job - ridx - 1,
                    utilization=pool.busy_seconds
                    / max(tw - t0, 1e-9)))
                prev_stale = stale_now
                if tr is not None and len(ctrl.trace) > n_ret:
                    for rt in ctrl.trace[n_ret:]:
                        tr.emit(telemetry.RETUNE, tc, job=job.job_id,
                                round=ridx,
                                value=float(rt["omega_new"]),
                                label=rt["reason"])
                    n_ret = len(ctrl.trace)
                stage["control"] += clock() - tc
                if not fused:
                    term = True
                    break
            # group end: close the fusion group (late results become
            # stale exactly once), cancel every level master-side, and
            # push the wire watermark over the whole group's seq
            self.fusion.end_group()
            for ctx in ctxs:
                ctx.purge()
            pool.purge_round(ctxs[-1])
            ridx0 = g_end
        return term, faulted, timed, global_round, prev_stale

    # -- the event loop --------------------------------------------------------
    def run(self, jobs: Sequence[JobSpec]
            ) -> tuple[metrics.RuntimeResult, list[LayeredResult]]:
        """Serve ``jobs`` FIFO; returns (measured result, per-job futures)."""
        if len(jobs) == 0:
            raise ValueError("need at least one job")
        return self._serve(_TraceSource(jobs), warmup_job=jobs[0])

    def serve_queue(self, queue: JobQueue
                    ) -> tuple[metrics.RuntimeResult, list[LayeredResult]]:
        """Serve an *open* :class:`JobQueue` until closed and drained.

        Continuous-admission mode (the serving gateway's substrate):
        producers ``put`` jobs from other threads while the master loop
        is mid-job, and a queued successor lands in the encode-ahead
        pipeline between rounds — one warm fleet, no restart.  Per-job
        deadlines travel on ``JobSpec.deadline_at`` (absolute seconds
        from :attr:`t0`); with no successor trace there is no §IV
        next-arrival signal, so ``cfg.deadline`` alone never terminates
        a queued job.

        Blocks until :meth:`JobQueue.close` and every queued job is
        served; returns the same artifacts as :meth:`run` (empty but
        well-formed arrays when zero jobs were queued).
        """
        return self._serve(_QueueSource(queue),
                           warmup_job=self._warmup_job())

    def _serve(self, source, warmup_job: JobSpec
               ) -> tuple[metrics.RuntimeResult, list[LayeredResult]]:
        cfg = self.cfg
        ctrl = self.controller
        kappa0 = ctrl.kappa.copy()      # geometry at run start (eq. 1)
        L = cfg.num_layers
        order = layering.all_minijobs_msb_first(cfg.m)
        cum = layering.cumulative_minijobs(cfg.m)

        tr = self.tracer
        pool = make_transport(cfg, sink=self.fusion.post,
                              rng=np.random.default_rng(cfg.seed + 1),
                              tracer=tr)
        pool.start()
        # the fault authority for this run: under "fail-fast" it is the
        # historical assert_alive (raises TransportDeadError); under
        # "degrade" it quarantines, re-dispatches, and decides when a job
        # must be released degraded — see repro_torch.runtime.faults
        sup = FaultSupervisor(cfg, pool, ctrl, tracer=tr)
        self._warmup(warmup_job)

        # per-job rows, appended in service order and stacked at the end:
        # queue mode has no up-front job count (zero jobs is well-formed)
        arrivals_l: list[float] = []
        starts_l: list[float] = []
        ends_l: list[float] = []
        lc_rows: list[np.ndarray] = []
        ok_rows: list[np.ndarray] = []
        term_l: list[bool] = []
        degr_l: list[bool] = []
        rel_l: list[int] = []
        ver_rows: Optional[list[np.ndarray]] = [] if self.verify else None
        futures: list[LayeredResult] = []
        stage = {name: 0.0 for name in metrics.STAGES}
        rounds_timed = 0
        global_round = 0                  # across jobs (controller clock)
        prev_stale = 0
        n_retunes = 0                     # controller retunes already traced
        R = len(order)
        prepared: dict[int, tuple] = {}   # job_id -> pre-decomposed planes

        t0 = clock()
        sup.set_origin(t0)
        source.bind(t0)
        self.t0 = t0
        self.started.set()
        try:
            while (job := source.next()) is not None:
                if sup.collapsed and sup.check():
                    # fleet below k and not coming back right now: no
                    # round can reach k results, so every remaining job
                    # is released *promptly* — no arrival sleep, no
                    # dispatch — at its best-ready resolution (nothing,
                    # for a job that never started), marked degraded
                    now = clock()
                    lr = (job.result if job.result is not None
                          else LayeredResult(job.job_id, L))
                    futures.append(lr)
                    lr.release(terminated=True)
                    arrivals_l.append(job.arrival)
                    starts_l.append(now - t0)
                    ends_l.append(now - t0)
                    lc_rows.append(np.full(L, np.inf))
                    ok_rows.append(np.zeros(L, dtype=bool))
                    term_l.append(True)
                    degr_l.append(True)
                    rel_l.append(lr.released_resolution)
                    if ver_rows is not None:
                        ver_rows.append(np.full(L, np.nan))
                    if tr is not None:
                        tr.emit(telemetry.JOB, now, 0.0, job=job.job_id,
                                label="degraded")
                    continue
                source.wait_arrival(job)
                start = clock()
                prep = prepared.pop(job.job_id, None)
                if prep is None:
                    ts = clock()
                    prep = self._prepare(job)
                    tp = clock()
                    stage["prep"] += tp - ts
                    if tr is not None:
                        tr.emit(telemetry.PREP, ts, tp - ts,
                                job=job.job_id)
                qa, qb, scale, ca, cb = prep
                lr = (job.result if job.result is not None
                      else LayeredResult(job.job_id, L))
                futures.append(lr)
                lr.mark_started(start)

                if job.deadline_at is not None:
                    # serving mode: a per-job absolute deadline is an
                    # unconditional release instant — an open stream has
                    # a queued successor in the limit, so §IV's second
                    # condition is taken as always met (and it takes
                    # precedence over cfg.deadline)
                    t_term = t0 + job.deadline_at
                else:
                    t_term = None
                    nh = source.successor_hint()
                    if cfg.deadline is not None and nh is not None:
                        # §IV: BOTH deadline excess AND a queued successor.
                        t_term = max(start + cfg.deadline, nh)
                # resolution window: max_resolution caps the round budget
                # (an admission down-resolve never computes LSB rounds it
                # will not release — a capped job that finishes them all
                # is complete, not terminated); min_resolution marks the
                # rounds the deadline may NOT cut, so the fusion wait is
                # unbounded inside them
                if job.max_resolution is not None:
                    R_job = cum[min(job.max_resolution, L - 1)]
                else:
                    R_job = R
                if job.min_resolution >= 0:
                    guaranteed = min(cum[min(job.min_resolution, L - 1)],
                                     R_job)
                else:
                    guaranteed = 0

                if cfg.code_family == "hierarchical":
                    # sub-task-granular path: grouped level rounds,
                    # per-level any-k fusion, salvage ledger
                    (term, faulted, timed, global_round,
                     prev_stale) = self._serve_hier_job(
                        job, lr, prep, pool, sup, t_term, R_job,
                        guaranteed, stage, global_round, prev_stale)
                    rounds_timed += timed
                else:
                    acc = np.zeros((qa.shape[1], qb.shape[1]), dtype=np.float64)
                    # per-side coded planes, filled on first use: the m**2
                    # rounds need only m A-side + m B-side encodes per job.
                    # Keyed by (T, plane): an ω retune mid-job switches the
                    # codeword length, and the old-T entries simply stop being
                    # hit (a switch costs at most m re-encodes per side).
                    enc_a: dict[tuple[int, int], np.ndarray] = {}
                    enc_b: dict[tuple[int, int], np.ndarray] = {}

                    def encode_round(pi, pj, ridx=-1):
                        """Encode one round under the controller's *current*
                        geometry; the returned buffer carries its own
                        ``(code, kappa)`` so a later retune never orphans it —
                        an already-encoded round dispatches and decodes with
                        the geometry it was built for."""
                        ts = clock()
                        rcode, rkappa = ctrl.code, ctrl.kappa
                        T = rcode.num_tasks
                        Xa = enc_a.get((T, pi))
                        if Xa is None:
                            Xa = enc_a[(T, pi)] = rcode.encode_a(
                                np.asarray(ca[pi], np.float64))
                        Yb = enc_b.get((T, pj))
                        if Yb is None:
                            Yb = enc_b[(T, pj)] = rcode.encode_b(
                                np.asarray(cb[pj], np.float64))
                        te = clock()
                        stage["encode"] += te - ts
                        if tr is not None:
                            tr.emit(telemetry.ENCODE, ts, te - ts,
                                    job=job.job_id, round=ridx)
                        return Xa, Yb, rcode, rkappa

                    def finish_round_traced(rf, ridx, l, published, ts, tp):
                        tr.emit(telemetry.DECODE, ts, tp - ts,
                                job=job.job_id, round=ridx)
                        if published:
                            tr.emit(telemetry.RESOLUTION, rf.fused_at,
                                    job=job.job_id, round=ridx,
                                    value=float(l), label=f"res{l}")

                    def finish_round(rf, ridx, l, pi, pj, rcode):
                        """Decode a fused round, publish its layer if last.

                        Runs *behind* the next round's dispatch, so the layer
                        is timestamped with the round's ``fused_at`` (its k-th
                        task arrival) — the simulator's order-statistic
                        semantics — not the later decode instant, keeping the
                        measured delay free of next-round dispatch cost.
                        """
                        ts = clock()
                        mini = rf.decode(rcode)
                        tp = clock()
                        stage["decode"] += tp - ts
                        acc[...] += mini * float(1 << ((pi + pj) * cfg.d))
                        published = ridx + 1 == cum[l]
                        if published:   # layer l's last mini-job fused
                            lr.mark_resolution(l, acc * scale, rf.fused_at)
                        stage["publish"] += clock() - tp
                        if tr is not None:
                            finish_round_traced(rf, ridx, l, published, ts, tp)

                    # prime the pipeline: round 0's codeword + injected delays
                    nxt = encode_round(order[0][1], order[0][2], 0)
                    nxt_delays = pool.sample_round_delays(nxt[3])
                    pending = None        # fused-but-undecoded previous round
                    term = False
                    faulted = False       # released by the fault supervisor
                    for ridx, (l, pi, pj) in enumerate(order[:R_job]):
                        if (t_term is not None and ridx >= guaranteed
                                and clock() >= t_term):
                            term = True   # don't dispatch a dead round
                            break
                        # per-round liveness gate: when rounds fuse fast the
                        # wait loops below may never time out, so a death
                        # would otherwise go undetected while dispatches pile
                        # buffers onto the corpse — fail-fast raises here,
                        # degrade quarantines and re-splits kappa before the
                        # next dispatch (True only on fleet collapse: there
                        # is no in-flight round to give up on at this point)
                        if sup.check():
                            faulted = term = True
                            break
                        ctx = RoundContext(job.job_id, ridx)
                        rf = self.fusion.begin_round(ctx, cfg.k)
                        rcode = nxt[2]
                        ts = t_disp = clock()
                        pool.submit_round(ctx, nxt[0], nxt[1], nxt[3],
                                          delays=nxt_delays)
                        # hand the supervisor the round's buffers + split so a
                        # worker death mid-round can re-dispatch the lost slice
                        sup.track_round(ctx, nxt[0], nxt[1], nxt[3], rf)
                        stage["dispatch"] += clock() - ts
                        rounds_timed += 1
                        global_round += 1
                        nxt = None
                        # -- overlapped with this round's worker compute: --
                        # 1. decode the previous round, publish its layer
                        if pending is not None:
                            finish_round(*pending)
                            pending = None
                        # 2. encode round r+1 + presample its delays into the
                        #    spare buffer, or (last round) digit-decompose the
                        #    next *queued* job — continuous admission lands
                        #    here: a job put() mid-service preps between
                        #    rounds with no fleet restart
                        if ridx + 1 < R_job:
                            _, npi, npj = order[ridx + 1]
                            nxt = encode_round(npi, npj, ridx + 1)
                            nxt_delays = pool.sample_round_delays(nxt[3])
                        else:
                            nj = source.peek_ready()
                            if nj is not None and nj.job_id not in prepared:
                                ts = clock()
                                prepared[nj.job_id] = self._prepare(nj)
                                tp = clock()
                                stage["prep"] += tp - ts
                                if tr is not None:
                                    tr.emit(telemetry.PREP, ts, tp - ts,
                                            job=nj.job_id)
                        # ---------------------------------------------------
                        ts = clock()
                        if t_term is None or ridx < guaranteed:
                            # unbounded wait (no deadline, or a guaranteed
                            # minimum-resolution round the deadline may not
                            # cut): slice it so a worker that died (OOM-kill,
                            # crashed child, dead remote host) is handled
                            # promptly — fail-fast raises out of sup.check();
                            # degrade quarantines/re-dispatches, returning
                            # True only when the round is beyond saving —
                            # instead of blocking the run forever on a round
                            # that can no longer reach k results
                            while not (fused := rf.wait(sup.wait_slice)):
                                if sup.check():
                                    faulted = True
                                    break
                        else:
                            # bounded wait: still slice it — a multi-second
                            # §IV deadline must not delay dead-host detection
                            # (socket heartbeats, process joins) to the
                            # termination instant
                            while True:
                                remaining = t_term - clock()
                                if remaining <= 0.0:
                                    fused = rf.wait(0.0)
                                    break
                                if (fused := rf.wait(min(remaining,
                                                         sup.wait_slice))):
                                    break
                                if sup.check():
                                    faulted = True
                                    break
                        if faulted and rf.wait(0.0):
                            # the round fused in the window between the wait
                            # timing out and the supervisor giving up on it —
                            # a completed round is never thrown away
                            fused, faulted = True, False
                        tw = clock()
                        stage["wait"] += tw - ts
                        if tr is not None:
                            tr.emit(telemetry.ROUND, t_disp, tw - t_disp,
                                    job=job.job_id, round=ridx,
                                    label="fused" if fused else "purged")
                        # reclaim the round's stragglers.  View-lifetime
                        # invariant for zero-copy transports: this round's
                        # accepted results are NOT yet decoded (decode rides
                        # one iteration behind, see ``pending``), so its
                        # purge must not recycle their result slots — only
                        # strictly older rounds', which this same loop
                        # already decoded (finish_round(r-1) above precedes
                        # purge(r) on this thread, hence precedes purge(r+1)
                        # a fortiori).  Dispatch-slot reuse is safe
                        # immediately: a straggler still reading a recycled
                        # block can only produce a result fusion rejects
                        # without dereferencing.
                        pool.purge_round(ctx)
                        # feed the controller this round's signals; a retune
                        # takes effect from the NEXT encode (the buffered
                        # round keeps the geometry it was encoded with)
                        tc = clock()       # purge wake-ups stay out of the
                        stale_now = self.fusion.stale_results   # control stage
                        ctrl.observe(RoundObservation(
                            round_idx=global_round - 1, job_id=job.job_id,
                            wait=tw - ts, fused=bool(fused),
                            stale=stale_now - prev_stale,
                            deadline_margin=(None if t_term is None
                                             else t_term - tw),
                            rounds_left=R_job - ridx - 1,
                            utilization=pool.busy_seconds
                            / max(tw - t0, 1e-9)))
                        prev_stale = stale_now
                        if tr is not None and len(ctrl.trace) > n_retunes:
                            for rt in ctrl.trace[n_retunes:]:
                                tr.emit(telemetry.RETUNE, tc, job=job.job_id,
                                        round=ridx,
                                        value=float(rt["omega_new"]),
                                        label=rt["reason"])
                            n_retunes = len(ctrl.trace)
                        stage["control"] += clock() - tc
                        if not fused:
                            term = True
                            break
                        pending = (rf, ridx, l, pi, pj, rcode)
                    if pending is not None:   # drain the decode-behind stage
                        finish_round(*pending)
                end = clock()
                lr.release(terminated=term)
                if tr is not None:
                    tr.emit(telemetry.JOB, start, end - start,
                            job=job.job_id,
                            label=("degraded" if faulted else
                                   "terminated" if term else "completed"))

                arrivals_l.append(job.arrival)
                starts_l.append(start - t0)
                ends_l.append(end - t0)
                term_l.append(term)
                degr_l.append(faulted)
                rel_l.append(lr.released_resolution)
                lc = np.full(L, np.inf)
                ok = np.zeros(L, dtype=bool)
                for l in range(L):
                    if lr.resolution_ready(l):
                        ok[l] = True
                        lc[l] = lr.ready_at(l) - start
                lc_rows.append(lc)
                ok_rows.append(ok)
                if self.verify:
                    ref = layering.layered_matmul_reference(
                        qa, qb, m=cfg.m, d=cfg.d).astype(np.float64) * scale
                    ver = np.full(L, np.nan)
                    for l in range(L):
                        if lr.resolution_ready(l):
                            denom = max(float(np.abs(ref[l]).max()), 1.0)
                            ver[l] = float(
                                np.abs(lr.resolution(l) - ref[l]).max()
                                / denom)
                    ver_rows.append(ver)
        finally:
            pool.shutdown()

        # transports that cross a wire expose frame/byte counters and the
        # zero-copy ledger (process: arena vs pickle rounds; socket:
        # serialization-copied vs out-of-band bytes, negotiated frame
        # protocol); purely in-process backends leave this None
        transport_stats = getattr(pool, "wire_stats", None)
        if cfg.code_family == "hierarchical":
            # the salvage ledger rides transport_stats on every backend:
            # sub-task results accepted at all, and the subset that landed
            # beyond the master's wait frontier (banked straggler work)
            transport_stats = dict(transport_stats or {})
            transport_stats["subtask_results"] = self.fusion.subtask_results
            transport_stats["salvaged_subtasks"] = (
                self.fusion.salvaged_subtasks)

        J = len(starts_l)
        result = metrics.RuntimeResult(
            arrivals=np.asarray(arrivals_l, dtype=np.float64),
            starts=np.asarray(starts_l, dtype=np.float64),
            ends=np.asarray(ends_l, dtype=np.float64),
            layer_compute=(np.vstack(lc_rows) if J
                           else np.zeros((0, L))),
            success=(np.vstack(ok_rows) if J
                     else np.zeros((0, L), dtype=bool)),
            terminated=np.asarray(term_l, dtype=bool), kappa=kappa0,
            worker_busy=pool.busy_seconds, wall_elapsed=clock() - t0,
            stale_results=self.fusion.stale_results,
            released=np.asarray(rel_l, dtype=np.int64),
            verify_errors=(None if ver_rows is None
                           else np.vstack(ver_rows) if J
                           else np.zeros((0, L))),
            stage_seconds=stage,
            stage_rounds=rounds_timed, controller=ctrl.summary(),
            omega_trace=list(ctrl.trace), backend=pool.name,
            transport_stats=transport_stats,
            tasks_done=pool.tasks_done, tasks_purged=pool.tasks_purged,
            fault_policy=cfg.fault_policy, fault_log=sup.fault_log,
            workers_lost=sup.workers_lost, degraded=np.asarray(
                degr_l, dtype=bool),
            trace_events=(tr.events() if tr is not None else None),
            trace_dropped=(tr.dropped if tr is not None else 0),
            trace_t0=t0,
            clock_sync=getattr(pool, "clock_sync", None))
        return result, futures


def run_jobs(cfg: RuntimeConfig, num_jobs: int, *, K: int = 64, M: int = 8,
             N: int = 8, verify: bool = False,
             arrivals: Optional[Sequence[float]] = None
             ) -> tuple[metrics.RuntimeResult, list[LayeredResult]]:
    """Convenience: generate ``num_jobs`` random jobs and run them."""
    jobs = make_jobs(cfg, num_jobs, K=K, M=M, N=N, arrivals=arrivals)
    return Master(cfg, verify=verify).run(jobs)
