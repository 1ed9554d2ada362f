"""The ``process`` backend: multiprocessing workers, zero-copy wire path.

True GIL-free parallel compute and *real* stragglers: each worker is an
OS process with a private duplex pipe.  The pipe is the *control* plane;
block payloads take the fastest path available:

* **Dispatch** — with the shared-memory arena enabled (``cfg.shm`` is
  ``auto``/``on``, see :mod:`repro_torch.runtime.transport.shm`), the master
  copies each worker's ``kappa_p``-slice once into the worker's dispatch
  :class:`~repro_torch.runtime.transport.shm.BlockArena` and sends only a
  descriptor (:class:`~repro_torch.runtime.tasks.ArenaBatchRef`: arena offsets,
  shapes, dtypes, ``seq``) down the pipe; the worker maps the blocks as
  ndarray views.  With the arena off — or full — the slice falls back to
  the original pickled :class:`~repro_torch.runtime.tasks.WireBatch` message,
  so exhaustion degrades to the pre-arena path, never an error.
* **Purge** — a ``("purge", seq)`` watermark message, exactly as before:
  workers drop every batch with ``seq <= watermark``, queued or
  in-flight (the delay wait polls the pipe).  The same watermark drives
  arena reclamation on both sides: the master recycles the purged
  round's dispatch slots immediately, the worker recycles result slots
  of rounds *strictly below* the watermark.  Slot reuse is safe because
  a purged round's results are *rejected by the fusion sink's dedupe*
  without ever being read (see
  :meth:`repro_torch.runtime.fusion.FusionNode.post`), and a fused round —
  decoded one master-loop iteration behind its own purge — is always
  decoded (copied out) before the *next* purge is sent.
* **Results** — workers compute each product straight into a slot of
  their result arena (the ``out=`` path of the compute kernel) and send
  an :class:`~repro_torch.runtime.tasks.ArenaResultRef` descriptor back on
  their *own pipe*; the master's drain thread hands fusion a zero-copy
  view of the slot.  Without an arena, results return as pickle
  protocol-5 envelopes with out-of-band ndarray buffers — one buffer
  copy on the pipe instead of a serialize/deserialize pair, and no
  shared ``mp.Queue`` (whose feeder thread added a scheduler hop and
  re-pickled every envelope at protocol 2... the default).  Either way
  the drain thread multiplexes all worker pipes with
  ``multiprocessing.connection.wait``.
* **Shutdown** — ``("stop", drain)`` then join, as before; afterwards
  the master unlinks every arena it created and sweeps ``/dev/shm`` for
  its own name prefix, so a SIGKILLed worker can never strand a segment
  (workers only ever *attach*; the master is the sole owner).

Timestamps: workers stamp ``finished_at`` with ``time.monotonic``, which
is CLOCK_MONOTONIC — system-wide, comparable across processes on Linux
(the platform this backend targets; the CI smoke job pins it).

Start method: ``forkserver`` where available, else ``spawn``.  The
master's process is usually multi-threaded (torch's and BLAS's pools, a
test runner's I/O threads, XLA's beside it), and a child ``fork``ed
from it inherits that state half-way: it may hang on a lock another
thread held, or die of a segmentation fault before it runs a line of
its own (workers forked from a pytest-xdist worker that had run torch
and JAX did, so that none of them came up).  A fork
server is a fresh single-threaded interpreter, started once per master
process, that imports this module (and with it torch and numpy) before
it forks anything; each worker is a fork of it, so it starts in
milliseconds with those imports done and inherits no thread state and
no file descriptor but its own pipe end (which the server passes it).
Workers compute on host BLAS and never touch CUDA, so a master that has
initialised CUDA is no concern either way.  The master still watches
liveness (:meth:`ProcessTransport.dead_worker_map` via
:meth:`~repro_torch.runtime.transport.base.WorkerTransport.assert_alive`)
so a child lost for *any* reason fails the run promptly instead of
hanging an unbounded fusion wait.  ``start_method`` (the reference's
parameter) takes ``"forkserver"`` or ``"spawn"``; ``"fork"`` raises.
"""

from __future__ import annotations

import collections
import multiprocessing
import multiprocessing.connection as _mpc
import pickle
import struct
import threading
from typing import Callable, Optional

import numpy as np

from repro_torch.runtime import telemetry
from repro_torch.runtime.tasks import (ArenaBatchRef, ArenaResultRef,
                                 RoundContext, RuntimeConfig, TaskResult,
                                 WireBatch, WireGroup)
from repro_torch.runtime.transport import shm as shm_mod
from repro_torch.runtime.transport.base import WorkerTransport
from repro_torch.runtime.worker import (BatchRunner, WAIT_SLICE, clock,
                                  make_compute)

__all__ = ["ProcessTransport"]


# -- result envelopes: pickle protocol 5, buffers out of band -----------------
#
# Worker -> master messages are byte envelopes on the worker's own duplex
# pipe (sent with send_bytes / received with recv_bytes, so they never
# touch the Connection's pickler):
#
#     [meta_len u32][nbuf u16][nbuf x u64 buffer lens][meta][buffers...]
#
# ``meta`` is the message tuple pickled at protocol 5 with a
# buffer_callback, so every contiguous ndarray payload is lifted out as a
# raw buffer instead of being copied through the pickle stream; unpacking
# reconstructs the arrays as zero-copy views over the received bytes.

_ENV_HEAD = struct.Struct("!IH")
_ENV_LEN = struct.Struct("!Q")


def _pack_envelope(msg: tuple) -> bytes:
    bufs: list[pickle.PickleBuffer] = []
    meta = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    parts = [_ENV_HEAD.pack(len(meta), len(raws)),
             b"".join(_ENV_LEN.pack(r.nbytes) for r in raws), meta]
    parts.extend(raws)
    return b"".join(parts)


def _unpack_envelope(payload: bytes) -> tuple:
    mv = memoryview(payload)
    meta_len, nbuf = _ENV_HEAD.unpack_from(mv, 0)
    off = _ENV_HEAD.size
    lens = [_ENV_LEN.unpack_from(mv, off + i * _ENV_LEN.size)[0]
            for i in range(nbuf)]
    off += nbuf * _ENV_LEN.size
    meta = mv[off:off + meta_len]
    off += meta_len
    buffers = []
    for n in lens:
        buffers.append(mv[off:off + n])
        off += n
    return pickle.loads(meta, buffers=buffers)


class _PipeResults:
    """The worker loop's result "queue": byte envelopes on its pipe."""

    __slots__ = ("_conn",)

    def __init__(self, conn):
        self._conn = conn

    def put(self, msg: tuple) -> None:
        self._conn.send_bytes(_pack_envelope(msg))


class _PipeGuard:
    """Worker-side cancellation guard backed by the control pipe.

    ``cancelled`` is true once the batch's ``seq`` falls under the purge
    watermark (or a purge-mode stop arrived); ``wait`` blocks on the pipe
    so a purge message interrupts an injected delay the moment it lands.
    """

    __slots__ = ("_loop", "_seq")

    def __init__(self, loop: "_WorkerLoop", seq: int):
        self._loop = loop
        self._seq = seq

    def cancelled(self) -> bool:
        self._loop.pump(block=False)
        return self._seq <= self._loop.watermark or self._loop.purging

    def wait(self, delay: float) -> bool:
        loop = self._loop
        end = clock() + delay
        while True:
            remaining = end - clock()
            if remaining <= 0.0:
                return False
            # block on the pipe, not time.sleep: a purge (or stop) message
            # wakes this worker immediately, like the thread backend's
            # cancel event.  WAIT_SLICE only caps the window so a dead
            # master can't strand a multi-second stall forever.
            if loop.conn.poll(timeout=min(remaining, WAIT_SLICE)):
                loop.pump(block=False)
            if self._seq <= loop.watermark or loop.purging:
                return True


class _GroupLevelGuard:
    """Per-level guard inside a group batch: cancels on the group's purge
    watermark (whole group dead) OR on a ``purgelvl`` mark for this
    level's round (level fused elsewhere) — later levels keep running."""

    __slots__ = ("_loop", "_seq", "_round")

    def __init__(self, loop: "_WorkerLoop", seq: int, round_idx: int):
        self._loop = loop
        self._seq = seq
        self._round = round_idx

    def _hit(self) -> bool:
        loop = self._loop
        return (self._seq <= loop.watermark or loop.purging
                or self._round <= loop.level_marks.get(self._seq, -1))

    def cancelled(self) -> bool:
        self._loop.pump(block=False)
        return self._hit()

    def wait(self, delay: float) -> bool:
        loop = self._loop
        end = clock() + delay
        while True:
            remaining = end - clock()
            if remaining <= 0.0:
                return False
            if loop.conn.poll(timeout=min(remaining, WAIT_SLICE)):
                loop.pump(block=False)
            if self._hit():
                return True


class _WorkerLoop:
    """One worker process's event loop (runs inside the child).

    Arena support is armed by an ``("arena", dispatch_name, result_name)``
    control message (sent by the master before the first arena-form
    round, so pipe FIFO ordering guarantees the attach happens first).
    Until then — and on the socket backend, always — the loop behaves
    exactly as the pickled path.
    """

    def __init__(self, worker_id: int, cfg: RuntimeConfig, conn, results):
        self.conn = conn
        self._results = results
        self.watermark = -1          # highest purged dispatch seq
        #: per-group level-purge marks: group seq -> highest purged round
        #: index within that group (a fused level's stragglers are
        #: reclaimed without touching the group's later levels)
        self.level_marks: dict[int, int] = {}
        self.stopping = False
        self._drain_on_stop = True
        self.queue: collections.deque = collections.deque()
        # worker-side tracer: events are stamped on THIS host's monotonic
        # clock and ride back piggybacked on result / final-stats
        # envelopes (optional trailing element, absent when tracing is
        # off so the wire format is unchanged for untraced runs)
        self.tracer = telemetry.Tracer() if cfg.trace else None
        self._base_compute = make_compute(cfg, worker_id)
        self._dispatch_arena = None      # attached on ("arena", ...)
        self._result_arena = None
        self._cur_seq = -1               # seq of the batch being run
        self._slot = None                # (ArenaSlice, view) mid-task
        self.runner = BatchRunner(worker_id, self._compute, self._emit,
                                  self.tracer)

    @property
    def purging(self) -> bool:
        return self.stopping and not self._drain_on_stop

    # -- compute: straight into the result arena when there is one -----------
    def _compute(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        arena = self._result_arena
        self._slot = None
        if arena is None:
            return self._base_compute(x, y)
        got = arena.alloc_view((x.shape[1], y.shape[1]),
                               np.result_type(x, y), self._cur_seq)
        if got is None:              # ring full: pickled-result fallback
            return self._base_compute(x, y)
        desc, view = got
        try:
            out = self._base_compute(x, y, out=view)
        except (TypeError, ValueError):
            # kernel without out= support, or a dtype the out-buffer
            # can't take exactly: compute normally (the orphaned slot is
            # recycled when the watermark passes it)
            return self._base_compute(x, y)
        self._slot = (desc, view)
        return out

    def _emit(self, result: TaskResult) -> None:
        slot, self._slot = self._slot, None
        if slot is not None and result.value is slot[1]:
            ref = ArenaResultRef(
                job_id=result.job_id, round_idx=result.round_idx,
                task_id=result.task_id, worker_id=result.worker_id,
                seq=self._cur_seq, value=slot[0],
                finished_at=result.finished_at)
            env = ("aresult", ref, self.runner.busy_seconds)
        else:
            env = ("result", result.to_wire(), self.runner.busy_seconds)
        if self.tracer is not None:
            env += (self.tracer.drain(),)
        self._results.put(env)

    def _handle(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "round":
            self.queue.append(msg[1])
        elif kind == "group":
            self.queue.append(msg[1])
        elif kind == "purgelvl":
            # level-scoped purge: cancel round msg[2] of group msg[1]
            # only — later levels of the group keep computing (they are
            # future rounds the master has not fused yet)
            seq, ridx = msg[1], msg[2]
            self.level_marks[seq] = max(self.level_marks.get(seq, -1), ridx)
        elif kind == "purge":
            self.watermark = max(self.watermark, msg[1])
            if self.level_marks:
                # group seqs at/below the watermark are dead wholesale;
                # their per-level marks are no longer reachable
                self.level_marks = {s: r for s, r in self.level_marks.items()
                                    if s > self.watermark}
            if self._result_arena is not None:
                # recycle result slots of rounds STRICTLY older than the
                # watermark, not the watermark round itself: the master
                # decodes a fused round one iteration behind its purge,
                # so purge(r) can still have round r's accepted views
                # undecoded — but decode(r) always precedes the send of
                # purge(r+1), which is when r's slots fall below the
                # watermark and recycle here.  (Rejected/stale results
                # are never dereferenced, so over-retention is the only
                # cost, bounded at one round.)
                self._result_arena.free_below(self.watermark)
        elif kind == "arena":
            self._dispatch_arena = shm_mod.BlockArena(
                0, name=msg[1], create=False)
            self._result_arena = shm_mod.BlockArena(
                0, name=msg[2], create=False)
        elif kind == "stop":
            self.stopping = True
            self._drain_on_stop = msg[1]
        else:  # pragma: no cover - protocol violation
            raise RuntimeError(f"unknown control message {kind!r}")

    def pump(self, *, block: bool) -> None:
        """Ingest every pending control message.

        With ``block=True``, additionally park on the pipe until there is
        *something* to do (a batch arrives, or stop) — the worker's idle
        state.  Purge watermarks are ingested either way, so a queued dead
        round is dropped before a single task of it runs.
        """
        while True:
            if self.conn.poll():
                self._handle(self.conn.recv())
                continue
            if block and not self.queue and not self.stopping:
                self._handle(self.conn.recv())   # idle: park on the pipe
                continue
            return

    def close_arenas(self) -> None:
        for arena in (self._dispatch_arena, self._result_arena):
            if arena is not None:
                arena.close()        # attach side: unmap only, no unlink
        self._dispatch_arena = None
        self._result_arena = None

    def run(self) -> None:
        while True:
            self.pump(block=True)
            if self.queue:
                batch = self.queue.popleft()
                if batch.seq <= self.watermark or self.purging:
                    self.runner.count_purged_any(batch)
                    continue
                self._cur_seq = batch.seq
                if isinstance(batch, WireGroup):
                    seq = batch.seq
                    self.runner.run_group(
                        batch.levels,
                        lambda lb: _GroupLevelGuard(self, seq,
                                                    lb.round_idx))
                    continue
                if isinstance(batch, ArenaBatchRef):
                    batch = batch.to_batch(self._dispatch_arena)
                self.runner.run(batch, _PipeGuard(self, batch.seq))
            elif self.stopping:
                break
        stats = ("stats", self.runner.worker_id,
                 self.runner.busy_seconds, self.runner.tasks_done,
                 self.runner.tasks_purged)
        if self.tracer is not None:
            stats += (self.tracer.drain(),)
        self._results.put(stats)


def _worker_main(worker_id: int, cfg: RuntimeConfig, conn) -> None:
    """Child-process entrypoint (module-level: picklable under spawn)."""
    loop = _WorkerLoop(worker_id, cfg, conn, _PipeResults(conn))
    try:
        loop.run()
    except (EOFError, BrokenPipeError, KeyboardInterrupt):
        pass                      # master died or interrupted: exit quietly
    finally:
        loop.close_arenas()
        conn.close()


class _ArenaPair:
    """Master-side handle on one worker's dispatch + result arenas."""

    __slots__ = ("dispatch", "result")

    def __init__(self, dispatch: shm_mod.BlockArena,
                 result: shm_mod.BlockArena):
        self.dispatch = dispatch
        self.result = result

    def teardown(self) -> None:
        for arena in (self.dispatch, self.result):
            arena.close()
            arena.unlink()       # owner side: the name dies with the run


class ProcessTransport(WorkerTransport):
    """``cfg.num_workers`` OS-process workers: control pipes + shared-
    memory block arenas (descriptor dispatch, zero-copy results)."""

    name = "process"

    def __init__(self, cfg: RuntimeConfig,
                 sink: Callable[[TaskResult], None],
                 rng: Optional[np.random.Generator] = None,
                 tracer=None, *,
                 start_method: Optional[str] = None):
        super().__init__(cfg, sink, rng, tracer)
        if start_method is None:
            methods = multiprocessing.get_all_start_methods()
            start_method = ("forkserver" if "forkserver" in methods
                            else "spawn")
        if start_method not in ("forkserver", "spawn"):
            raise ValueError(f"start_method {start_method!r}: workers start "
                             f"from a fork server or by spawn (the module "
                             f"docstring)")
        self._mp = multiprocessing.get_context(start_method)
        if start_method == "forkserver":
            # the server imports the worker's module once, before any fork
            # (a no-op for a server this process already started)
            self._mp.set_forkserver_preload([__name__])
        self._conns = []
        self.processes = []
        for p in range(cfg.num_workers):
            parent, child = self._mp.Pipe()
            proc = self._mp.Process(
                target=_worker_main, args=(p, cfg, child),
                name=f"runtime-proc-worker-{p}", daemon=True)
            self._conns.append((parent, child))
            self.processes.append(proc)
        # arenas are created lazily at the first dispatch per worker
        # (sized from the actual slice), under a unique /dev/shm prefix
        # so shutdown's leak sweep has an exact ground truth
        self._arena_mode = cfg.shm          # "auto" | "on" | "off"
        self._arena_prefix = shm_mod.arena_prefix()
        self._arenas: dict[int, _ArenaPair] = {}
        self._arena_failed: set[int] = set()
        self._busy = np.zeros(cfg.num_workers)
        self._done = 0
        self._purged = 0
        self._stats_lock = threading.Lock()
        # wire accounting (wire_stats): all monotonic counters, kept past
        # shutdown so the master can report them with the run result
        self._arena_rounds = 0          # slices dispatched as descriptors
        self._pickle_rounds = 0         # slices dispatched as pickles
        self._group_dispatches = 0      # hierarchical group messages sent
        self._arena_fallbacks = 0       # ring-full (or dead-pipe) declines
        self._arena_dispatch_bytes = 0  # block bytes copied into arenas
        self._pickle_dispatch_bytes = 0  # block bytes sent through pickles
        self._arena_results = 0         # results returned as descriptors
        self._pickle_results = 0        # results returned in envelopes
        self._stale_arena_results = 0   # arena results fusion rejected
        self._drainer = threading.Thread(target=self._drain, daemon=True,
                                         name="runtime-process-drain")
        self._started = False
        self._shutting_down = False
        self._stop_drain = threading.Event()

    # -- master side ---------------------------------------------------------
    def start(self) -> None:
        for proc in self.processes:
            proc.start()
        for _, child in self._conns:
            child.close()        # parent keeps only its end of each pipe
        self._drainer.start()
        self._started = True

    # -- arena management (master thread only) -------------------------------
    def _ensure_arena(self, worker_id: int, x: np.ndarray, y: np.ndarray
                      ) -> Optional[_ArenaPair]:
        """The worker's arena pair, created + announced on first use.

        Sized from the first slice: the ring only ever holds the (at
        most two) in-flight rounds plus slack, and a later job too big
        for it degrades per-slice to the pickled path.
        """
        pair = self._arenas.get(worker_id)
        if pair is not None:
            return pair
        if self._arena_mode == "off" or worker_id in self._arena_failed:
            return None
        slice_bytes = x.nbytes + y.nbytes
        item_bytes = (x.shape[2] * y.shape[2]
                      * np.result_type(x, y).itemsize)
        try:
            dispatch = shm_mod.BlockArena(
                max(1 << 20, 8 * slice_bytes),
                name=f"{self._arena_prefix}d{worker_id}")
            try:
                result = shm_mod.BlockArena(
                    max(1 << 20, 32 * x.shape[0] * item_bytes),
                    name=f"{self._arena_prefix}r{worker_id}")
            except BaseException:
                dispatch.close()
                dispatch.unlink()
                raise
        except Exception:
            if self._arena_mode == "on":
                raise
            self._arena_failed.add(worker_id)   # auto: degrade quietly
            return None
        try:
            self._conns[worker_id][0].send(
                ("arena", dispatch.name, result.name))
        except (BrokenPipeError, OSError):
            # worker died before the announce: nothing attached, reclaim
            for arena in (dispatch, result):
                arena.close()
                arena.unlink()
            self._arena_failed.add(worker_id)
            return None
        pair = _ArenaPair(dispatch, result)
        self._arenas[worker_id] = pair
        return pair

    def _send_slice(self, worker_id: int, ctx: RoundContext, first_task: int,
                    x: np.ndarray, y: np.ndarray,
                    delays: np.ndarray) -> None:
        """One round slice: an arena descriptor when the blocks fit, the
        pickled ``("round", WireBatch)`` message otherwise."""
        pair = self._ensure_arena(worker_id, x, y)
        if pair is not None:
            xd = pair.dispatch.write(x, ctx.seq)
            yd = pair.dispatch.write(y, ctx.seq) if xd is not None else None
            if yd is not None:
                ref = ArenaBatchRef(seq=ctx.seq, job_id=ctx.job_id,
                                    round_idx=ctx.round_idx,
                                    first_task_id=first_task,
                                    x=xd, y=yd, delays=delays)
                try:
                    self._conns[worker_id][0].send(("round", ref))
                except (BrokenPipeError, OSError):
                    # worker died under us: drop the slice, like the
                    # socket backend — redundancy may still fuse the
                    # round, and the next liveness check reports the
                    # death either way (the slots recycle at purge)
                    return
                self._arena_rounds += 1
                self._arena_dispatch_bytes += x.nbytes + y.nbytes
                return
            # ring full (an unpurged backlog): fall back for this slice
            self._arena_fallbacks += 1
            if self._tracer is not None:
                self._tracer.emit(telemetry.ARENA, clock(),
                                  job=ctx.job_id, round=ctx.round_idx,
                                  worker=worker_id,
                                  value=pair.dispatch.used_fraction,
                                  label="fallback")
        wire = WireBatch(seq=ctx.seq, job_id=ctx.job_id,
                         round_idx=ctx.round_idx, first_task_id=first_task,
                         x=x, y=y, delays=delays)
        try:
            self._conns[worker_id][0].send(("round", wire))
        except (BrokenPipeError, OSError):
            return
        self._pickle_rounds += 1
        self._pickle_dispatch_bytes += x.nbytes + y.nbytes

    def _send_group(self, worker_id: int, seq: int,
                    entries: list[tuple]) -> None:
        """One pickled ``("group", WireGroup)`` message per worker.

        Groups always ride the pickled pipe path: per-level slices are a
        fraction of a flat round each, and the block arena's seq-keyed
        ring reclamation is level-blind (config validation rejects
        ``shm='on'`` with the hierarchical family for exactly this
        reason).
        """
        levels = tuple(
            WireBatch(seq=seq, job_id=ctx.job_id, round_idx=ctx.round_idx,
                      first_task_id=lo, x=x, y=y, delays=d)
            for ctx, lo, x, y, d in entries)
        group = WireGroup(seq=seq, job_id=levels[0].job_id,
                          base_round=levels[0].round_idx, levels=levels)
        try:
            self._conns[worker_id][0].send(("group", group))
        except (BrokenPipeError, OSError):
            return               # worker died under us: drop the slices
        self._group_dispatches += 1
        self._pickle_dispatch_bytes += sum(b.x.nbytes + b.y.nbytes
                                           for b in levels)

    def purge_level(self, ctx: RoundContext) -> None:
        """Level-scoped purge: reclaim one fused level's stragglers with
        a ``("purgelvl", seq, round)`` mark while the group's later
        levels keep computing (banked ahead-of-frontier work)."""
        ctx.purge()              # master side: fusion drops stale results
        if ctx.seq < 0:
            return               # never dispatched
        for conn, _ in self._conns:
            try:
                if not conn.closed:
                    conn.send(("purgelvl", ctx.seq, ctx.round_idx))
            except (BrokenPipeError, OSError):  # worker already gone
                pass

    def dead_worker_map(self) -> dict[int, str]:
        if not self._started or self._shutting_down:
            return {}
        return {p: f"{proc.name} (exit code {proc.exitcode})"
                for p, proc in enumerate(self.processes)
                if not proc.is_alive()}

    def _quarantine_worker(self, worker_id: int, reason: str) -> None:
        """Retire a dead worker process: reap it and close the master's
        pipe end so shutdown cannot block on a corpse.  Its final stats
        envelope is lost with it — the fault log records the loss.  Its
        arenas stay mapped (master-owned) until shutdown unlinks them:
        a SIGKILLed attacher leaks nothing."""
        proc = self.processes[worker_id]
        if proc.is_alive():      # defensive: quarantine targets the dead
            proc.terminate()
        proc.join(timeout=1.0)
        try:
            conn = self._conns[worker_id][0]
            if not conn.closed:
                conn.close()
        except OSError:          # pragma: no cover - already closed
            pass

    def purge_round(self, ctx: RoundContext) -> None:
        ctx.purge()              # master side: fusion drops stale results
        if ctx.seq < 0:
            return               # never dispatched
        for conn, _ in self._conns:
            try:
                if not conn.closed:
                    conn.send(("purge", ctx.seq))
            except (BrokenPipeError, OSError):  # worker already gone
                pass
        if self._arenas:
            # recycle the purged rounds' dispatch slots immediately.
            # Safe even with stragglers mid-compute on them: a worker
            # still reading a recycled block can only produce a result
            # for a round that is already fused or cancelled, which the
            # fusion sink rejects without dereferencing — ctx.purge()
            # above happens-before any reuse of the region.
            occupancy = 0.0
            for pair in self._arenas.values():
                occupancy = max(occupancy, pair.dispatch.used_fraction)
                pair.dispatch.free_through(ctx.seq)
            if self._tracer is not None:
                self._tracer.emit(telemetry.ARENA, clock(),
                                  job=ctx.job_id, round=ctx.round_idx,
                                  value=occupancy, label="reclaim")

    def shutdown(self, timeout: float = 10.0, *, drain: bool = False
                 ) -> None:
        self._shutting_down = True
        if not self._started:
            for proc in self.processes:
                if proc.is_alive():  # pragma: no cover - defensive
                    proc.terminate()
            self._teardown_arenas()
            return
        for conn, _ in self._conns:
            try:
                if not conn.closed:
                    conn.send(("stop", drain))
            except (BrokenPipeError, OSError):
                pass
        leaked = []
        for proc in self.processes:
            proc.join(timeout=timeout)
            if proc.is_alive():
                leaked.append(proc.name)
                proc.terminate()
                proc.join(timeout=1.0)
        # orderly workers wrote results + final stats into their pipes
        # before exiting; the buffered tail stays readable after the
        # process is gone, so the drain loop empties it and exits on the
        # stop flag once nothing more is pending
        self._stop_drain.set()
        self._drainer.join(timeout=timeout)
        for conn, _ in self._conns:
            try:
                if not conn.closed:
                    conn.close()
            except OSError:      # pragma: no cover - raced the drain
                pass
        self._teardown_arenas()
        if leaked:
            raise RuntimeError(
                f"worker processes failed to stop within {timeout}s "
                f"(terminated): {leaked}")

    def _teardown_arenas(self) -> None:
        """Owner-side unlink of every arena + a /dev/shm leak sweep.

        The sweep is the SIGKILL backstop: whatever happened to the
        workers (they only attach) or to this teardown's bookkeeping, no
        segment under this transport's prefix survives the call.
        """
        for pair in self._arenas.values():
            pair.teardown()
        self._arenas.clear()
        shm_mod.unlink_segments(self._arena_prefix)

    # -- result drain (master-side thread) -----------------------------------
    def _drain(self) -> None:
        conns = [parent for parent, _ in self._conns]
        while True:
            live = [c for c in conns if not c.closed]
            if not live:
                if self._stop_drain.wait(timeout=0.05):
                    return
                continue
            try:
                ready = _mpc.wait(live, timeout=0.25)
            except (OSError, ValueError):
                # a pipe was closed under the wait (quarantine): re-scan
                continue
            if not ready:
                if self._stop_drain.is_set():
                    return       # joined workers + idle pipes: all drained
                continue
            for conn in ready:
                self._pump_conn(conn)

    def _pump_conn(self, conn) -> None:
        try:
            payload = conn.recv_bytes()
        except (EOFError, OSError, ValueError):
            # worker exited (EOF after its buffered tail) or the pipe
            # closed underneath us: stop waiting on this conn.  The
            # master's send paths all tolerate the closed end.
            try:
                if not conn.closed:
                    conn.close()
            except OSError:      # pragma: no cover - raced shutdown
                pass
            return
        try:
            msg = _unpack_envelope(payload)
        except Exception:        # pragma: no cover - killed mid-write
            return
        kind = msg[0]
        if kind == "result":
            wire, busy = msg[1], msg[2]
            result = TaskResult.from_wire(wire)
            with self._stats_lock:
                self._busy[result.worker_id] = busy
                self._pickle_results += 1
            # piggybacked worker events (traced runs only); process
            # workers share the system-wide CLOCK_MONOTONIC, so no
            # clock rebase is needed
            if len(msg) > 3 and self._tracer is not None:
                self._tracer.ingest(msg[3])
            self._sink(result)
        elif kind == "aresult":
            ref, busy = msg[1], msg[2]
            pair = self._arenas.get(ref.worker_id)
            if pair is None:     # arena already torn down (late stats)
                return
            result = ref.to_result(pair.result)
            with self._stats_lock:
                self._busy[ref.worker_id] = busy
                self._arena_results += 1
            if len(msg) > 3 and self._tracer is not None:
                self._tracer.ingest(msg[3])
            # the fusion sink's verdict IS the slot-lifetime decision:
            # accepted values are copied out at decode, rejected ones are
            # never read — either way nothing master-side pins the slot
            # once the purge watermark passes it (worker-side reclaim)
            if self._sink(result) is False:
                with self._stats_lock:
                    self._stale_arena_results += 1
        elif kind == "stats":
            worker_id, busy, done, purged = msg[1:5]
            with self._stats_lock:
                self._busy[worker_id] = busy
                self._done += done
                self._purged += purged
            if len(msg) > 5 and self._tracer is not None:
                self._tracer.ingest(msg[5])

    # -- wire accounting ------------------------------------------------------
    @property
    def wire_stats(self) -> dict:
        """Dispatch/result path counters (all plain ints/bools/strs).

        ``shm_active`` reports whether any arena actually ran (``auto``
        may have degraded); the ``*_bytes`` counters split block traffic
        by path, so "bytes copied through a pickler" is directly
        readable: it is the ``pickle_*`` share.
        """
        with self._stats_lock:
            return {
                "transport": "process",
                "shm": self._arena_mode,
                "shm_active": bool(self._arena_rounds),
                "arena_rounds": self._arena_rounds,
                "pickle_rounds": self._pickle_rounds,
                "group_dispatches": self._group_dispatches,
                "arena_fallbacks": self._arena_fallbacks,
                "dispatch_arena_bytes": self._arena_dispatch_bytes,
                "dispatch_pickle_bytes": self._pickle_dispatch_bytes,
                "arena_results": self._arena_results,
                "pickle_results": self._pickle_results,
                "stale_arena_results": self._stale_arena_results,
            }

    # -- occupancy / outcome counters ----------------------------------------
    @property
    def busy_seconds(self) -> np.ndarray:
        """Per-worker occupancy; live values ride each result envelope
        (so this lags a worker's *current* delay wait by one task), and
        the final stats envelopes make it exact after shutdown."""
        with self._stats_lock:
            return self._busy.copy()

    @property
    def tasks_done(self) -> int:
        """Exact after shutdown (final stats); 0 while running."""
        with self._stats_lock:
            return self._done

    @property
    def tasks_purged(self) -> int:
        """Exact after shutdown (final stats); 0 while running."""
        with self._stats_lock:
            return self._purged
