"""Shared task/job/config types for the asynchronous runtime.

The runtime executes the paper's system for real: each *job* is a coded
layered matmul ``A.T @ B``; each of its ``m**2`` *mini-jobs* (one digit
plane pair ``(i, j)``) is polynomial-encoded into ``T = ceil(k * omega)``
*coded tasks* that are dispatched to concurrent workers.  A mini-job is one
master-paced *round*: it fuses as soon as any ``k`` task results land, and
the master purges the round's stragglers.

``RoundContext`` carries the purge signal: workers wait out their injected
straggler delay on ``cancel`` so a purge (or job termination) reclaims them
*immediately* — the runtime analogue of the simulator's "workers idle until
the round boundary" semantics.

Wire forms: :class:`RoundBatch` and :class:`TaskResult` are the *local*
(zero-copy, live-object) forms the thread backend hands around;
:class:`WireBatch` and :meth:`TaskResult.to_wire` /
:meth:`TaskResult.from_wire` are their transport-serializable twins — no
threading primitives, only primitives + contiguous ndarrays — used by any
backend that crosses a process (or host) boundary.  The cancel event does
not serialize; remote purging is a transport concern (a purge message
against the batch's monotonic ``seq``, see
:mod:`repro_torch.runtime.transport.process`).

Four backends carry the rounds (:data:`BACKEND_NAMES`): ``thread`` and
``cuda`` are in-process (host BLAS, or a CUDA device per worker thread);
``process`` runs OS-process workers over pipes and shared-memory arenas
(the :class:`ArenaSlice` descriptors below); ``socket`` runs TCP worker
hosts (``hosts``, ``compress``, ``frame_proto``, the heartbeat and
reconnect fields).  The process and socket workers compute on host BLAS.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

import numpy as np

from repro_torch.core import coding, layering, scheduling

__all__ = ["RuntimeConfig", "JobSpec", "RoundContext", "RoundBatch",
           "GroupBatch", "TaskResult", "WireBatch", "WireGroup",
           "ArenaSlice", "ArenaBatchRef", "ArenaResultRef",
           "BACKEND_NAMES", "CODE_FAMILIES", "COMPRESS_MODES",
           "FAULT_POLICIES", "SHM_MODES", "FRAME_PROTOS"]

#: Worker-transport backends the runtime can dispatch over (see
#: :mod:`repro_torch.runtime.transport`): host threads, OS processes,
#: threads whose coded products run on CUDA devices, or TCP worker hosts.
BACKEND_NAMES = ("thread", "process", "cuda", "socket")

#: Coded-task families: ``polynomial`` is the paper's flat §II-A code
#: (one codeword per round, a purge discards a straggler's whole task);
#: ``hierarchical`` stacks ``levels`` per-level MDS codewords per
#: dispatch (Ferdinand & Draper), aligned MSB-plane-first with the digit
#: layering, so a straggler's completed sub-tasks stay decode-usable.
CODE_FAMILIES = ("polynomial", "hierarchical")

#: Worker-loss policies (see :mod:`repro_torch.runtime.faults`): ``fail-fast``
#: raises :class:`~repro_torch.runtime.errors.TransportDeadError` on the first
#: dead worker; ``degrade`` quarantines it, re-dispatches its lost tasks
#: to survivors, and releases jobs at a degraded resolution when the
#: fleet drops below the recovery threshold ``k``.
FAULT_POLICIES = ("fail-fast", "degrade")

#: Result/batch compression modes for the socket transport's frame
#: protocol (see :mod:`repro_torch.runtime.transport.socket_host`): ``auto``
#: compresses payloads above a size threshold with the best available
#: codec, ``zlib``/``lz4`` force one codec, ``none`` disables.
COMPRESS_MODES = ("auto", "none", "zlib", "lz4")

#: Shared-memory arena modes for the process backend (see
#: :mod:`repro_torch.runtime.transport.shm`): ``auto`` uses the zero-copy block
#: arena when the platform supports it and silently falls back to the
#: pickled pipe path otherwise; ``on`` requires it (construction fails
#: where shared memory is unavailable); ``off`` disables it.
SHM_MODES = ("auto", "on", "off")

#: Socket frame protocol selection: ``0`` negotiates the highest version
#: both ends speak (LRF2 against a current worker host, LRF1 against an
#: older one); ``1``/``2`` pin the offered protocol (``1`` = the pickled
#: LRF1 frames every release speaks, ``2`` = zero-copy LRF2 ndarray
#: frames).
FRAME_PROTOS = (0, 1, 2)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Cluster + code + workload parameters for a runtime execution.

    Mirrors :class:`repro_torch.core.simulator.SystemConfig` where the concepts
    overlap (``mu``, ``arrival_rate``, ``m``, ``omega``, ``gamma``,
    ``complexity``) so measured runs validate directly against
    ``simulate()`` (the paper's §IV system); adds the code geometry
    (``n1``, ``n2``, ``d``), the straggler-injection model that the
    simulator only samples, and the online redundancy controller
    (``adapt``, see :mod:`repro_torch.runtime.adaptive`).

    Units: every duration field (``deadline``, ``stall_seconds``,
    ``shift_at``, ``burst_period``, ``burst_len``) is wall-clock seconds;
    ``arrival_rate`` and ``mu`` are per-second rates.  Instances are frozen
    (hashable, safely shared across threads); all derived properties are
    pure functions of the fields.
    """

    mu: tuple[float, ...] = (385.95, 650.92, 373.40, 415.75, 373.98)
    arrival_rate: float = 50.0     # Poisson job arrivals per second
    n1: int = 2                    # polynomial-code column blocks of A
    n2: int = 2                    # polynomial-code column blocks of B
    omega: float = 1.5             # redundancy ratio: T = ceil(n1*n2*omega)
    m: int = 2                     # digit chunks -> L = 2m-1 resolutions
    d: int = 8                     # digit width (bits)
    gamma: float = 1.0             # eq. (1) moment trade-off
    complexity: float = 1.0        # per-task complexity (full, unlayered)
    deadline: Optional[float] = None   # seconds from service start
    straggler: str = "none"        # "none"|"exp"|"stall"|"shift"|"burst"
    stall_workers: tuple[int, ...] = ()   # worker ids that go dark
    stall_seconds: float = 30.0    # stall duration (>> any deadline)
    shift_at: float = 0.0          # "shift": seconds until regime change
    burst_period: float = 1.0      # "burst": seconds between burst starts
    burst_len: float = 0.2        # "burst": stall window per period
    adapt: str = "fixed"           # omega policy: adaptive.POLICIES key
    omega_min: float = 1.0         # adaptive omega lower bound
    omega_max: float = 3.0         # adaptive omega upper bound
    backend: str = "cuda"          # worker transport: BACKEND_NAMES key
    hosts: tuple[str, ...] = ()    # socket backend: "host:port" per worker
    compress: str = "auto"         # socket frame codec: COMPRESS_MODES key
    shm: str = "auto"              # process backend arena: SHM_MODES key
    frame_proto: int = 0           # socket frame protocol: FRAME_PROTOS key
    code_family: str = "polynomial"   # coded-task family: CODE_FAMILIES key
    levels: int = 1                # hierarchical: sub-tasks per dispatch
    fault_policy: str = "fail-fast"   # worker loss: FAULT_POLICIES key
    heartbeat_interval: float = 1.0   # socket: seconds between pings
    heartbeat_timeout: float = 15.0   # socket: silence -> worker dead
    reconnect_attempts: int = 2       # socket: re-dials before giving up
    reconnect_backoff: float = 0.05   # socket: base re-dial backoff (s)
    reconnect_backoff_cap: float = 2.0  # socket: exp backoff ceiling (s)
    trace: bool = False            # structured tracing (telemetry module);
    #                                off by default and free when off
    seed: int = 0

    def __post_init__(self):
        if self.straggler not in ("none", "exp", "stall", "shift", "burst"):
            raise ValueError(f"unknown straggler model {self.straggler!r}")
        if self.backend not in BACKEND_NAMES:
            raise ValueError(f"unknown worker backend {self.backend!r}; "
                             f"known: {BACKEND_NAMES}")
        if self.compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compress mode {self.compress!r}; "
                             f"known: {COMPRESS_MODES}")
        if self.backend == "socket":
            if len(self.hosts) != self.num_workers:
                raise ValueError(
                    f"backend='socket' needs one host:port per worker: got "
                    f"{len(self.hosts)} hosts for {self.num_workers} "
                    f"workers (mu has {self.num_workers} entries)")
            for h in self.hosts:
                host, sep, port = h.rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(
                        f"socket host {h!r} is not of the form 'host:port'")
        elif self.hosts:
            # hosts with a non-socket backend would be silently ignored —
            # reject the contradiction
            raise ValueError(
                f"hosts= is only meaningful with backend='socket' "
                f"(got backend={self.backend!r})")
        if self.shm not in SHM_MODES:
            raise ValueError(f"unknown shm mode {self.shm!r}; "
                             f"known: {SHM_MODES}")
        if self.shm == "on" and self.backend != "process":
            # "on" is a hard requirement for the shared-memory arena,
            # which only the process backend implements; with any other
            # backend it would be silently ignored — reject the
            # contradiction, mirroring the hosts= rule ("auto"/"off" are
            # fine anywhere: no-ops off the process backend)
            raise ValueError(
                f"shm='on' is only meaningful with backend='process' "
                f"(got backend={self.backend!r})")
        if self.frame_proto not in FRAME_PROTOS:
            raise ValueError(f"unknown frame_proto {self.frame_proto!r}; "
                             f"known: {FRAME_PROTOS}")
        if self.frame_proto and self.backend != "socket":
            # a pinned frame protocol with a non-socket backend would be
            # silently ignored — reject the contradiction (0 = negotiate
            # is the anywhere-safe default)
            raise ValueError(
                f"frame_proto={self.frame_proto} is only meaningful with "
                f"backend='socket' (got backend={self.backend!r})")
        if self.code_family not in CODE_FAMILIES:
            raise ValueError(f"unknown code family {self.code_family!r}; "
                             f"known: {CODE_FAMILIES}")
        if self.code_family == "hierarchical":
            if self.levels < 2:
                raise ValueError(
                    f"code_family='hierarchical' needs levels >= 2 (one "
                    f"level IS the polynomial family); got {self.levels}")
            if self.shm == "on":
                # group dispatches carry per-level slices over the pickled
                # pipe path — the block arena's seq-keyed ring reclamation
                # is level-blind, so requiring it would silently degrade
                # to pickling anyway; reject the contradiction
                raise ValueError(
                    "shm='on' is incompatible with "
                    "code_family='hierarchical': group dispatch bypasses "
                    "the block arena (use shm='auto' or 'off')")
        elif self.levels != 1:
            # a level count with the flat family would be silently
            # ignored — reject the contradiction, mirroring hosts=
            raise ValueError(
                f"levels={self.levels} is only meaningful with "
                f"code_family='hierarchical' (got "
                f"code_family={self.code_family!r})")
        if self.fault_policy not in FAULT_POLICIES:
            raise ValueError(f"unknown fault policy {self.fault_policy!r}; "
                             f"known: {FAULT_POLICIES}")
        if self.heartbeat_interval <= 0.0:
            raise ValueError(f"heartbeat_interval must be > 0, got "
                             f"{self.heartbeat_interval}")
        if self.heartbeat_timeout <= self.heartbeat_interval:
            raise ValueError(
                f"heartbeat_timeout ({self.heartbeat_timeout}) must exceed "
                f"heartbeat_interval ({self.heartbeat_interval}): a timeout "
                f"shorter than one ping period declares every worker dead")
        if self.reconnect_attempts < 0:
            raise ValueError(f"reconnect_attempts must be >= 0, got "
                             f"{self.reconnect_attempts}")
        if not 0.0 < self.reconnect_backoff <= self.reconnect_backoff_cap:
            raise ValueError(
                f"need 0 < reconnect_backoff <= reconnect_backoff_cap, got "
                f"{self.reconnect_backoff} / {self.reconnect_backoff_cap}")
        if self.omega < 1.0:
            raise ValueError(f"redundancy ratio must be >= 1, got {self.omega}")
        if any(not 0 <= w < len(self.mu) for w in self.stall_workers):
            raise ValueError(f"stall_workers {self.stall_workers} out of "
                             f"range for {len(self.mu)} workers")
        if not 1.0 <= self.omega_min <= self.omega_max:
            raise ValueError(f"need 1 <= omega_min <= omega_max, got "
                             f"[{self.omega_min}, {self.omega_max}]")
        if self.straggler == "burst" and not (
                0.0 < self.burst_len <= self.burst_period):
            raise ValueError(f"need 0 < burst_len <= burst_period, got "
                             f"{self.burst_len} / {self.burst_period}")
        if self.straggler in ("shift", "burst") and not self.stall_workers:
            raise ValueError(
                f"straggler={self.straggler!r} needs stall_workers: with "
                f"none, the regime change is a silent no-op (plain 'exp')")

    @property
    def num_workers(self) -> int:
        return len(self.mu)

    @property
    def k(self) -> int:
        """Recovery threshold: any k of the T coded tasks decode a round."""
        return self.n1 * self.n2

    @property
    def total_tasks(self) -> int:
        return max(self.k, math.ceil(self.k * self.omega))

    @property
    def num_layers(self) -> int:
        return layering.num_layers(self.m)

    @property
    def num_rounds(self) -> int:
        return self.m * self.m

    @property
    def minijob_complexity(self) -> float:
        return self.complexity / (self.m * self.m)

    def code(self, omega: Optional[float] = None) -> coding.PolynomialCode:
        """The float-mode polynomial code for this geometry.

        ``omega`` overrides the configured redundancy (same ``k``, different
        codeword length ``T``) — how the adaptive controller materializes a
        retuned geometry while everything else stays fixed.
        """
        return coding.PolynomialCode(
            n1=self.n1, n2=self.n2,
            omega=self.omega if omega is None else omega, mode="float")

    def hier_code(self, levels: Optional[int] = None,
                  omega: Optional[float] = None) -> coding.HierarchicalCode:
        """The hierarchical code family for this geometry.

        ``levels`` overrides the configured level count (the master clips
        the last dispatch group of a job to the rounds that remain);
        ``omega`` overrides the redundancy the same way :meth:`code` does,
        so the adaptive controller's retunes and the fault supervisor's
        fleet refits flow into the per-level lengths unchanged.
        """
        return coding.HierarchicalCode(
            n1=self.n1, n2=self.n2,
            levels=self.levels if levels is None else levels,
            omega=self.omega if omega is None else omega, mode="float")

    def to_system_config(self):
        """The §IV simulator configuration this runtime config realises.

        Time units line up because the simulator's per-task time for
        complexity c on worker p is Exp(mu_p / c) — exactly the runtime's
        "exp" straggler injection in seconds.
        """
        from repro_torch.core import simulator
        return simulator.SystemConfig(
            mu=self.mu, arrival_rate=self.arrival_rate, k=self.k,
            complexity=self.complexity, m=self.m, omega=self.omega,
            gamma=self.gamma)

    def load_split(self, total: Optional[int] = None,
                   active: Optional[tuple[int, ...]] = None) -> np.ndarray:
        """Eq. (1) integer task split kappa_p over workers (sum == total).

        ``total`` defaults to the configured ``total_tasks``; the adaptive
        controller passes a retuned codeword length instead, recomputing
        the split for the new ``T`` against the same worker moments.

        ``active`` restricts the split to a surviving subset of workers
        (the fault supervisor's quarantine path): the eq. (1) optimization
        runs over the survivors' moments only, and every non-active worker
        gets ``kappa_p = 0``.  The returned vector always has
        ``num_workers`` entries so transport indexing is unchanged.
        """
        if active is None:
            active = tuple(range(self.num_workers))
        else:
            active = tuple(sorted(set(active)))
            if not active:
                raise ValueError("load_split needs at least one active "
                                 "worker")
            if any(not 0 <= p < self.num_workers for p in active):
                raise ValueError(f"active workers {active} out of range "
                                 f"for {self.num_workers} workers")
        stats = [scheduling.worker_job_moments(self.mu[p], self.k,
                                               self.minijob_complexity)
                 for p in active]
        sub = scheduling.load_split(
            stats, self.total_tasks if total is None else total, self.gamma)
        if len(active) == self.num_workers:
            return sub
        kappa = np.zeros(self.num_workers, dtype=sub.dtype)
        kappa[list(active)] = sub
        return kappa


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job: compute ``a.T @ b`` with layered resolution.

    ``a (K, M)`` and ``b (K, N)``; float inputs are quantized to ``m*d``
    bits at service start (ints pass through).  ``arrival`` is the offset in
    seconds from the run start at which the job enters the queue.

    The serving fields give each job its *own* deadline contract (the
    multi-tenant gateway's per-request semantics) instead of the global
    ``RuntimeConfig.deadline``:

    ``deadline_at``
        Absolute release instant, seconds from the run start (same clock
        as ``arrival``).  Unlike the §IV trace rule — which terminates
        only with BOTH deadline excess AND a queued successor — a per-job
        deadline is unconditional: an open request stream is the queued
        successor in the limit, so the job releases its best-ready
        resolution at this instant no matter what is behind it.  Takes
        precedence over ``RuntimeConfig.deadline``.
    ``min_resolution``
        Resolutions up to this index are computed even past
        ``deadline_at`` (the "always release *something*" serving
        guarantee; -1 disables it, so a job that starts after its
        deadline releases immediately with nothing).
    ``max_resolution``
        Caps the job at ``cumulative_minijobs(m)[max_resolution]``
        rounds — how a down-resolved admission actually sheds fleet
        work.  A capped job that runs all its rounds is *complete* (not
        terminated): it delivered its admitted resolution.
    ``result``
        Optional pre-built :class:`~repro_torch.runtime.fusion.LayeredResult`
        the master publishes into; lets a submitter hold the future
        *before* the job reaches service (the gateway's drain thread
        waits on it).  The master builds its own when None.
    """

    job_id: int
    a: np.ndarray
    b: np.ndarray
    arrival: float = 0.0
    deadline_at: Optional[float] = None
    min_resolution: int = -1
    max_resolution: Optional[int] = None
    result: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.deadline_at is not None and self.deadline_at < 0.0:
            raise ValueError(
                f"deadline_at is seconds from run start, must be >= 0; "
                f"got {self.deadline_at}")
        if self.min_resolution < -1:
            raise ValueError(f"min_resolution must be >= -1 (-1 = no "
                             f"guarantee), got {self.min_resolution}")
        if self.max_resolution is not None:
            if self.max_resolution < 0:
                raise ValueError(f"max_resolution must be >= 0, got "
                                 f"{self.max_resolution}")
            if self.min_resolution > self.max_resolution:
                raise ValueError(
                    f"min_resolution {self.min_resolution} exceeds "
                    f"max_resolution {self.max_resolution}")


class RoundContext:
    """Purge/cancel state shared by one round's coded tasks.

    ``cancel`` is set when the round fuses (purge) or the job is terminated;
    workers block on it instead of sleeping so reclamation is immediate.
    The event is a *local* primitive: in-process backends share it with
    their workers directly, while remote backends keep it master-side (the
    fusion node still checks it to drop stale results) and propagate the
    purge over the wire against ``seq`` — the transport-assigned, globally
    monotonic dispatch sequence number (-1 until submitted).
    """

    __slots__ = ("job_id", "round_idx", "cancel", "seq")

    def __init__(self, job_id: int, round_idx: int):
        self.job_id = job_id
        self.round_idx = round_idx
        self.cancel = threading.Event()
        self.seq = -1

    @property
    def cancelled(self) -> bool:
        return self.cancel.is_set()

    def purge(self) -> None:
        self.cancel.set()


@dataclasses.dataclass(frozen=True)
class RoundBatch:
    """One worker's slice of a round's codeword, dispatched as a unit.

    ``x``/``y`` are zero-copy views into the round's encoded ``(T, K, *)``
    buffers (``X[lo:hi]``), not per-task copies: the worker indexes task
    ``i`` as ``x[i]``/``y[i]`` (again views) right before computing.  One
    queue append + one notify per worker per round, instead of ``kappa_p``
    task objects.
    """

    ctx: RoundContext
    first_task_id: int      # codeword index of x[0]
    x: np.ndarray           # (n, K, M/n1) view of coded A blocks
    y: np.ndarray           # (n, K, N/n2) view of coded B blocks
    delays: np.ndarray      # (n,) injected straggler delays (seconds)

    @property
    def count(self) -> int:
        return self.x.shape[0]

    @property
    def job_id(self) -> int:
        return self.ctx.job_id

    @property
    def round_idx(self) -> int:
        return self.ctx.round_idx

    def to_wire(self) -> "WireBatch":
        """Serializable twin of this batch (drops the live context).

        Pickling an ndarray view serializes only the viewed slice, so the
        wire form stays as small as the batch itself.
        """
        return WireBatch(seq=self.ctx.seq, job_id=self.ctx.job_id,
                         round_idx=self.ctx.round_idx,
                         first_task_id=self.first_task_id,
                         x=self.x, y=self.y, delays=self.delays)


@dataclasses.dataclass(frozen=True)
class WireBatch:
    """Transport-serializable form of :class:`RoundBatch`.

    Primitives + ndarrays only — safe over a pipe, socket, or shared
    memory.  ``seq`` is the transport's monotonic dispatch counter: a purge
    message names a sequence watermark, and a remote worker drops every
    batch (queued or in-flight) with ``seq <= watermark``.
    """

    seq: int
    job_id: int
    round_idx: int
    first_task_id: int
    x: np.ndarray           # (n, K, M/n1) coded A blocks
    y: np.ndarray           # (n, K, N/n2) coded B blocks
    delays: np.ndarray      # (n,) injected straggler delays (seconds)

    @property
    def count(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True)
class GroupBatch:
    """One worker's slice of a hierarchical dispatch group (local form).

    ``levels`` holds one :class:`RoundBatch` per level the worker was
    assigned sub-tasks for, in MSB-first level order — level l is
    plane-pair round ``base_round + l``.  The worker runs them in order
    with a cancellation checkpoint before every sub-task, so a purge of
    one fused level skips exactly that level's remainder while later
    levels (banked ahead-of-frontier work) keep computing.  Each level
    keeps its *own* :class:`RoundContext` (they fuse and purge
    independently); the group shares one transport ``seq``.
    """

    levels: tuple[RoundBatch, ...]

    @property
    def count(self) -> int:
        return sum(b.count for b in self.levels)


@dataclasses.dataclass(frozen=True)
class WireGroup:
    """Transport-serializable twin of :class:`GroupBatch`.

    One :class:`WireBatch` per level, all stamped with the group's shared
    ``seq``: the existing purge watermark drops a whole queued group,
    while a ``purgelvl`` message (seq + round index) cancels a single
    fused level without touching its siblings.
    """

    seq: int
    job_id: int
    base_round: int
    levels: tuple[WireBatch, ...]

    @property
    def count(self) -> int:
        return sum(b.count for b in self.levels)


@dataclasses.dataclass(frozen=True)
class TaskResult:
    """A completed coded task, as delivered to the fusion node."""

    job_id: int
    round_idx: int
    task_id: int
    worker_id: int
    value: np.ndarray       # (M/n1, N/n2)
    finished_at: float      # wall-clock (time.monotonic)

    def to_wire(self) -> tuple:
        """Flat picklable tuple (the cross-process result envelope)."""
        return (self.job_id, self.round_idx, self.task_id, self.worker_id,
                self.value, self.finished_at)

    @staticmethod
    def from_wire(wire: tuple) -> "TaskResult":
        """Rebuild a result on the master side of a transport."""
        job_id, round_idx, task_id, worker_id, value, finished_at = wire
        return TaskResult(job_id=job_id, round_idx=round_idx,
                          task_id=task_id, worker_id=worker_id,
                          value=value, finished_at=finished_at)


# -- shared-memory arena descriptors ------------------------------------------
#
# The zero-copy twins of WireBatch / TaskResult.to_wire(): when master and
# worker share a BlockArena (repro_torch.runtime.transport.shm), the pipe
# carries only these descriptors — a few ints and a dtype string — and
# each side maps the block payloads as ndarray views into the arena.
# ``seq`` plays double duty: the purge watermark AND the ring-allocator
# reclamation key, so slot lifetime rides the purge protocol that already
# exists.

@dataclasses.dataclass(frozen=True)
class ArenaSlice:
    """One block's location in a shared-memory arena (wire descriptor).

    ``dtype`` is the numpy dtype *string* (``'<f8'``), not the dtype
    object, so the descriptor pickles as pure primitives.
    """

    offset: int             # byte offset into the arena segment
    shape: tuple[int, ...]  # ndarray shape of the block
    dtype: str              # np.dtype(...).str

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * math.prod(self.shape))


@dataclasses.dataclass(frozen=True)
class ArenaBatchRef:
    """Descriptor form of :class:`WireBatch`: blocks live in the dispatch
    arena, only ``delays`` (a ``(n,)`` float vector) rides the pipe."""

    seq: int
    job_id: int
    round_idx: int
    first_task_id: int
    x: ArenaSlice           # (n, K, M/n1) coded A blocks, in the arena
    y: ArenaSlice           # (n, K, N/n2) coded B blocks, in the arena
    delays: np.ndarray      # (n,) injected straggler delays (seconds)

    @property
    def count(self) -> int:
        return self.x.shape[0]

    def to_batch(self, arena) -> "WireBatch":
        """Materialize as a :class:`WireBatch` of views into ``arena``
        (any object with a ``view(ArenaSlice) -> ndarray`` method)."""
        return WireBatch(seq=self.seq, job_id=self.job_id,
                         round_idx=self.round_idx,
                         first_task_id=self.first_task_id,
                         x=arena.view(self.x), y=arena.view(self.y),
                         delays=self.delays)


@dataclasses.dataclass(frozen=True)
class ArenaResultRef:
    """Descriptor form of a result envelope: the value matrix lives in
    the worker's result arena (the compute kernel wrote it there)."""

    job_id: int
    round_idx: int
    task_id: int
    worker_id: int
    seq: int                # dispatch seq of the result's round
    value: ArenaSlice       # (M/n1, N/n2) product block, in the arena
    finished_at: float      # worker-side time.monotonic

    def to_result(self, arena) -> "TaskResult":
        """Materialize as a :class:`TaskResult` whose value is a zero-copy
        view into ``arena`` — handed straight to the fusion sink."""
        return TaskResult(job_id=self.job_id, round_idx=self.round_idx,
                          task_id=self.task_id, worker_id=self.worker_id,
                          value=arena.view(self.value),
                          finished_at=self.finished_at)
