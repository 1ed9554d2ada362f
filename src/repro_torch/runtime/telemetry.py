"""Low-overhead structured tracing for the layered-resolution runtime.

The runtime's headline artifacts are *timing distributions* — res-0 delay
vs final, deadline success under stragglers (paper §IV, Figs. 4–5) — but
aggregate counters cannot answer "which worker stalled round 17, when did
its purge land, and why did res-1 miss the deadline by 3 ms".  This module
is the event layer that can: a :class:`Tracer` collects typed
:class:`TraceEvent` records covering the full task lifecycle

    encode → dispatch(seq) → worker task span → result arrival
           → fused | purged | stale

plus round spans, per-resolution release instants, omega retunes, and
transport liveness (heartbeat RTT, reconnects, dead workers).

Design constraints, in order:

1. **Free when off.**  Tracing is opt-in via
   :attr:`repro_torch.runtime.tasks.RuntimeConfig.trace`; when off the tracer
   is ``None`` and every call site is guarded with ``if tr is not None``
   — no event objects, no dict building, no lock traffic.
2. **Lock-cheap when on.**  Each recording thread appends to its own
   ring buffer (``threading.local``); the only lock is taken once per
   thread at registration and once at collection time.  Worker threads,
   the fusion sink, transport receiver threads, and the master loop never
   contend on a shared structure per event.
3. **One timeline across hosts.**  Remote workers stamp events on their
   *own* monotonic clocks and ship them back piggybacked on result /
   final-stats envelopes; the socket transport estimates each link's
   clock offset from ping/pong exchanges (offset = t_worker − midpoint
   of the master's send/recv instants, taken at the minimum observed
   RTT, so the alignment error is bounded by rtt/2) and
   :meth:`Tracer.ingest` rebases the events into the master's clock
   domain on arrival.

Events are plain ``NamedTuple`` rows (picklable across process/socket
boundaries); exporters live in :mod:`repro_torch.runtime.trace_export`.
"""

from __future__ import annotations

import http.server
import threading
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

__all__ = [
    "TraceEvent", "Tracer", "EVENT_KINDS", "SPAN_KINDS", "INSTANT_KINDS",
    "PREP", "ENCODE", "DISPATCH", "ROUND", "DECODE", "RESOLUTION", "JOB",
    "RETUNE", "TASK", "RESULT", "FUSED", "STALE", "HEARTBEAT", "RECONNECT",
    "DEAD", "QUARANTINE", "READMIT", "REDISPATCH", "REQUEST", "ADMIT",
    "RELEASE", "ARENA", "serve_metrics", "worker_metrics_text",
]

clock = time.monotonic

# -- event taxonomy -----------------------------------------------------------
#
# Master pipeline (one per master loop iteration / stage):
PREP = "prep"              # span: operand prep for one job
ENCODE = "encode"          # span: polynomial encode of one round
DISPATCH = "dispatch"      # instant: round handed to transport; value = seq
ROUND = "round"            # span: dispatch → fuse/purge; label fused|purged
DECODE = "decode"          # span: decode + accumulate of one fused round
RESOLUTION = "resolution"  # instant: resolution l released; value = l
JOB = "job"                # span: service start → completed|terminated
RETUNE = "retune"          # instant: omega retuned; value = new omega
# Fusion node (result arrival at the master sink):
RESULT = "result"          # instant: accepted result; task/worker set
FUSED = "fused"            # instant: k-th result fused the round
STALE = "stale"            # instant: rejected result (late/purged round)
# Worker side (stamped on the executing host's clock, rebased on ingest):
TASK = "task"              # span: delay wait + compute; label done|purged,
#                            value = injected delay (seconds)
# Transport liveness:
HEARTBEAT = "hb"           # instant: pong received; value = RTT (seconds)
RECONNECT = "reconnect"    # instant: link re-established after a drop
DEAD = "dead"              # instant: worker declared dead; label = reason
# Fault supervision (degrade policy, repro_torch.runtime.faults):
QUARANTINE = "quarantine"  # instant: dead worker removed from the fleet;
#                            label = death reason
READMIT = "readmit"        # instant: quarantined worker rejoined (socket
#                            reconnect + hello/watermark resync)
REDISPATCH = "redispatch"  # instant: a lost slice re-sent to a survivor;
#                            value = task count, worker = new owner
# Zero-copy wire path (repro_torch.runtime.transport.shm):
ARENA = "arena"            # instant: arena event; label = reclaim (slots
#                            recycled at a purge; value = peak dispatch-
#                            ring occupancy fraction) | fallback (ring
#                            full, slice took the pickled pipe path)
# Serving gateway (repro_torch.runtime.gateway; one lifecycle per
# request):
REQUEST = "request"        # span: submit -> client release; label =
#                            admitted|down-resolved|rejected[/degraded],
#                            value = released resolution (-1 = nothing)
ADMIT = "admit"            # instant: admission verdict; value = admitted
#                            resolution (-1 = rejected), label = decision
RELEASE = "release"        # instant: client release (deadline fire or
#                            early completion); value = resolution

SPAN_KINDS = frozenset({PREP, ENCODE, ROUND, DECODE, JOB, TASK, REQUEST})
INSTANT_KINDS = frozenset({DISPATCH, RESOLUTION, RETUNE, RESULT, FUSED,
                           STALE, HEARTBEAT, RECONNECT, DEAD, QUARANTINE,
                           READMIT, REDISPATCH, ADMIT, RELEASE, ARENA})
EVENT_KINDS = SPAN_KINDS | INSTANT_KINDS


class TraceEvent(NamedTuple):
    """One typed trace record.

    ``t`` is seconds on the recorder's monotonic clock — after
    :meth:`Tracer.ingest` rebasing, always the *master's* clock domain.
    ``dur`` is 0.0 for instants.  Unused id fields are -1; ``value``
    carries the kind-specific scalar payload (seq, layer, omega, RTT,
    injected delay) and ``label`` the kind-specific tag
    (``done``/``purged``/``fused``/reason strings).
    """

    kind: str
    t: float
    dur: float = 0.0
    job: int = -1
    round: int = -1
    task: int = -1
    worker: int = -1
    value: float = 0.0
    label: str = ""


class _Ring:
    """A bounded per-thread event buffer: overwrite-oldest on overflow."""

    __slots__ = ("buf", "cap", "head", "dropped")

    def __init__(self, cap: int):
        self.buf: List[TraceEvent] = []
        self.cap = cap
        self.head = 0           # next overwrite slot once full
        self.dropped = 0

    def append(self, ev: TraceEvent) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(ev)
        else:
            self.buf[self.head] = ev
            self.head = (self.head + 1) % self.cap
            self.dropped += 1

    def snapshot(self) -> List[TraceEvent]:
        if self.head:
            return self.buf[self.head:] + self.buf[:self.head]
        return list(self.buf)

    def clear(self) -> None:
        self.buf = []
        self.head = 0


class Tracer:
    """Lock-cheap multi-thread event collector.

    Every recording thread gets its own :class:`_Ring` (created lazily,
    registered once under the tracer lock); :meth:`emit` is then a pure
    thread-local append.  :meth:`events` merges all rings time-sorted;
    :meth:`drain` additionally clears them — the worker-host side uses
    drain to piggyback pending events onto outbound envelopes.
    """

    def __init__(self, capacity: int = 1 << 16):
        self._capacity = capacity
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self._capacity)
            with self._lock:
                self._rings.append(ring)
            self._local.ring = ring
        return ring

    def emit(self, kind: str, t: float, dur: float = 0.0, job: int = -1,
             round: int = -1, task: int = -1, worker: int = -1,
             value: float = 0.0, label: str = "") -> None:
        """Record one event on the calling thread's ring."""
        self._ring().append(
            TraceEvent(kind, t, dur, job, round, task, worker, value, label))

    def ingest(self, events: Iterable[Tuple], shift: float = 0.0) -> None:
        """Adopt remote-stamped events, rebased into this clock domain.

        ``shift`` is added to every timestamp: for a link with estimated
        clock offset ``off = worker_clock − master_clock``, pass
        ``shift=-off`` so remote spans land on the master timeline.
        """
        ring = self._ring()
        if shift == 0.0:
            for ev in events:
                ring.append(TraceEvent(*ev))
        else:
            for ev in events:
                ring.append(TraceEvent(ev[0], ev[1] + shift, *ev[2:]))

    def events(self) -> List[TraceEvent]:
        """All recorded events, time-sorted (non-destructive)."""
        with self._lock:
            rings = list(self._rings)
        out: List[TraceEvent] = []
        for ring in rings:
            out.extend(ring.snapshot())
        out.sort(key=lambda ev: ev.t)
        return out

    def drain(self) -> List[TraceEvent]:
        """Take and clear all pending events (time-sorted)."""
        with self._lock:
            rings = list(self._rings)
        out: List[TraceEvent] = []
        for ring in rings:
            out.extend(ring.snapshot())
            ring.clear()
        out.sort(key=lambda ev: ev.t)
        return out

    @property
    def dropped(self) -> int:
        """Events lost to ring overflow (0 unless a run out-paced the
        per-thread capacity)."""
        with self._lock:
            return sum(r.dropped for r in self._rings)


# -- live metrics endpoint ----------------------------------------------------

def worker_metrics_text(runner, *, worker_id: int = -1,
                        sessions: int = 0) -> str:
    """Prometheus text-format snapshot of one worker host's live counters.

    ``runner`` is the host's current :class:`~repro_torch.runtime.worker.
    BatchRunner` (or ``None`` between sessions); served by
    ``runctl serve-worker --metrics-port`` for scraping mid-run.
    """
    wid = getattr(runner, "worker_id", worker_id)
    busy = getattr(runner, "busy_seconds", 0.0)
    done = getattr(runner, "tasks_done", 0)
    purged = getattr(runner, "tasks_purged", 0)
    lab = f'{{worker="{wid}"}}'
    return "".join([
        "# HELP repro_worker_busy_seconds Injected-delay + compute "
        "occupancy of this worker host.\n",
        "# TYPE repro_worker_busy_seconds counter\n",
        f"repro_worker_busy_seconds{lab} {busy:.6f}\n",
        "# HELP repro_worker_tasks_done_total Coded tasks computed and "
        "emitted.\n",
        "# TYPE repro_worker_tasks_done_total counter\n",
        f"repro_worker_tasks_done_total{lab} {done}\n",
        "# HELP repro_worker_tasks_purged_total Tasks reclaimed by round "
        "purges before completion.\n",
        "# TYPE repro_worker_tasks_purged_total counter\n",
        f"repro_worker_tasks_purged_total{lab} {purged}\n",
        "# HELP repro_worker_sessions_total Master sessions served by "
        "this host process.\n",
        "# TYPE repro_worker_sessions_total counter\n",
        f"repro_worker_sessions_total{lab} {sessions}\n",
    ])


def serve_metrics(render, port: int = 0, host: str = "127.0.0.1"):
    """Serve ``render()`` as a Prometheus text endpoint on ``/metrics``.

    Returns ``(server, bound_port)``; the server runs on a daemon thread
    until ``server.shutdown()``.  ``render`` is called per request, so the
    text always reflects live counters.
    """

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib handler naming
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr spam
            del args

    server = http.server.ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-endpoint", daemon=True)
    thread.start()
    return server, server.server_address[1]
