"""The ``socket`` backend: TCP worker hosts behind the transport seam.

The first genuinely multi-HOST transport: each worker is a standalone
``worker_host`` process (``runctl serve-worker``, possibly on another
machine) listening on a TCP port; the master-side :class:`SocketTransport`
dials one connection per worker and speaks a length-prefixed frame
protocol over it.  The §IV contract is the process backend's, faced at a
network for the first time:

* **Dispatch** — each worker's ``kappa_p``-slice ships as a
  :class:`~repro_torch.runtime.tasks.WireBatch` inside a ``("round", wire)``
  frame.  Frames above a size threshold are transparently compressed
  (zlib, or lz4 when installed — the big coded blocks and result matrices
  are the ROADMAP's "result-path compression" case); the frame header is
  self-describing, so each side decodes whatever the other chose.
* **Purge** — ``("purge", seq)`` is the same watermark message the
  process backend uses: the worker drops every batch with
  ``seq <= watermark``, queued *or* currently delaying (the delay wait
  polls the socket, so a purge interrupts it immediately).
* **Results** — ``("result", wire, busy_seconds)`` frames return on the
  same connection; a master-side receiver thread per worker rebuilds
  :class:`~repro_torch.runtime.tasks.TaskResult` and posts it to the fusion
  sink.
* **Liveness** — a master-side heartbeat thread pings every worker; a
  worker that has not produced *any* frame (pong, result, stats) within
  ``heartbeat_timeout`` — or whose connection dropped and could not be
  re-established — is reported dead via
  :meth:`~repro_torch.runtime.transport.base.WorkerTransport.assert_alive`, so
  a SIGKILLed host fails the run promptly instead of hanging fusion.
* **Reconnect-or-fail** — a dropped connection (sever, host restart
  window) is re-dialed a bounded number of times; on success the master
  re-sends its hello carrying the session id and the current purge
  watermark, so rounds lost with the connection are cleanly dropped by
  the worker the moment it resumes.  On failure the worker is dead.
* **Shutdown** — ``("stop", drain)``: the worker drains or purges its
  queue, answers with a final ``("stats", ...)`` envelope (exact
  ``tasks_done``/``tasks_purged``/``busy_seconds``), and closes the
  session; the host then loops back to ``accept`` for the next master.
  No master-side thread outlives the call.

Frame layout (16-byte header, network byte order)::

    0      4    5     6      8         12        16
    ┌──────┬────┬─────┬──────┬─────────┬─────────┐
    │MAGIC │ver │codec│ rsvd │ raw_len │wire_len │ payload (wire_len B)
    └──────┴────┴─────┴──────┴─────────┴─────────┘
    MAGIC = b"LRF1" (v1) or b"LRF2" (v2); codec ∈ {none, zlib, lz4};
    raw_len is the decompressed payload size (integrity-checked).

An **LRF1** payload is one pickle of the message.  An **LRF2** payload
is pickle-free for ndarray data::

    ┌─────────┬──────┬────────────┬──────┬─────────────────┐
    │meta_len │ nbuf │ nbuf × len │ meta │ buffers ...     │
    │   u32   │ u16  │    u64     │      │ (raw C order)   │
    └─────────┴──────┴────────────┴──────┴─────────────────┘

``meta`` is the message tuple pickled at protocol 5 with a
``buffer_callback``, so every contiguous ndarray (the coded blocks, the
result matrices) is lifted *out of the pickle stream*: its dtype, shape,
and contiguity ride in ``meta`` (numpy's reconstructor) while the bytes
themselves are appended as raw buffers — memoryviews over the original
arrays, handed straight to the compressor / socket with no intermediate
serialization copy.  Control messages (purge, ping, stats) simply have
``nbuf = 0`` and stay pure pickle.  The protocol is negotiated in the
hello (see :func:`serve_worker_host`): LRF1 peers remain readable for
one release, and a v2-offering master fails clean — a clear
``ConnectionError``, not a garbled stream — against a worker host that
predates the offer.

The worker-side event loop *is* the process backend's
(:class:`~repro_torch.runtime.transport.process._WorkerLoop` over a socket
adapter), so purge/drain/occupancy semantics cannot drift between the
single-host and multi-host paths.  :class:`LocalCluster` spawns worker
hosts on localhost ports — the conformance suite's stand-in for a real
cluster, and the fault-injection harness (SIGKILL a host, sever a
connection).

Security note: frames carry pickles, as the multiprocessing backend's
pipes do.  The protocol authenticates nothing — run it on a trusted
network segment only (the paper's cluster model), never an open port on
the internet.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import random
import select
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid
import zlib
from typing import Callable, Optional

import numpy as np
import pickle

from repro_torch.runtime import telemetry
from repro_torch.runtime.tasks import (RoundContext, RuntimeConfig, TaskResult,
                                 WireBatch, WireGroup)
from repro_torch.runtime.transport.base import WorkerTransport
from repro_torch.runtime.transport.process import _WorkerLoop

__all__ = ["SocketTransport", "LocalCluster", "FrameError", "encode_frame",
           "decode_frame", "serve_worker_host", "MAGIC", "MAGIC2", "CODECS"]

clock = time.monotonic

# -- frame protocol -----------------------------------------------------------

MAGIC = b"LRF1"
_VERSION = 1
MAGIC2 = b"LRF2"
_VERSION2 = 2
#: LRF2 payload prologue: meta_len(4) nbuf(2), then nbuf u64 buffer lens
_V2HEAD = struct.Struct("!IH")
_V2LEN = struct.Struct("!Q")
#: header: magic(4) version(1) codec(1) reserved(2) raw_len(4) wire_len(4)
_HEADER = struct.Struct("!4sBBHII")
HEADER_SIZE = _HEADER.size

CODEC_NONE, CODEC_ZLIB, CODEC_LZ4 = 0, 1, 2
CODECS = {"none": CODEC_NONE, "zlib": CODEC_ZLIB, "lz4": CODEC_LZ4}

#: "auto" mode compresses only payloads at least this large: the typical
#: control message (purge/ping/stats) is tens of bytes and would pay the
#: codec call for nothing, while coded blocks and result matrices of any
#: interesting size clear it easily.
COMPRESS_MIN_BYTES = 4096

try:                               # optional: the container may lack lz4
    import lz4.frame as _lz4
except ImportError:                # pragma: no cover - depends on image
    _lz4 = None


def have_lz4() -> bool:
    """True when the optional lz4 codec is importable."""
    return _lz4 is not None


class FrameError(Exception):
    """A frame failed to parse: bad magic/version/codec, truncation, or a
    decompressed-size mismatch.  Deliberately distinct from the connection
    errors (EOFError/OSError) that mean the peer went away."""


def _compress(payload: bytes, codec: int) -> bytes:
    if codec == CODEC_ZLIB:
        return zlib.compress(payload, 1)
    if codec == CODEC_LZ4:
        return _lz4.compress(payload)
    return payload


def _decompress(payload: bytes, codec: int) -> bytes:
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == CODEC_LZ4:
        if _lz4 is None:
            raise FrameError("frame compressed with lz4 but lz4 is not "
                             "installed on this side")
        return _lz4.decompress(payload)
    return payload


def _pick_codec(compress: str, raw_len: int) -> int:
    """Codec id for ``compress`` mode and a payload of ``raw_len``."""
    if compress == "zlib":
        return CODEC_ZLIB
    if compress == "lz4":
        if _lz4 is None:
            raise ValueError("compress='lz4' but lz4 is not installed; "
                             "use 'zlib' or 'auto'")
        return CODEC_LZ4
    if compress == "auto" and raw_len >= COMPRESS_MIN_BYTES:
        return CODEC_LZ4 if _lz4 is not None else CODEC_ZLIB
    if compress not in ("auto", "none"):
        raise ValueError(f"unknown compress mode {compress!r}")
    return CODEC_NONE


def _compress_parts(parts: list, codec: int) -> bytes:
    """Compress a multi-part payload without first joining it.

    The zlib path streams each part through one ``compressobj`` — the
    ndarray memoryviews feed the compressor directly, so the only copy
    of the block bytes is the compressed output itself.  (lz4's one-shot
    API wants a single buffer; it pays the join.)
    """
    if codec == CODEC_ZLIB:
        z = zlib.compressobj(1)
        out = [z.compress(p) for p in parts]
        out.append(z.flush())
        return b"".join(out)
    return _compress(b"".join(parts), codec)


def _encode_v2_parts(obj) -> tuple:
    """LRF2 payload for ``obj``: ``(parts, inband_len, oob_len)``.

    ``parts`` is a flat list of buffers (prologue + meta pickle + raw
    ndarray buffers); ``inband_len`` is what went *through* the pickler
    (prologue + meta), ``oob_len`` the ndarray bytes that did not.
    """
    bufs: list[pickle.PickleBuffer] = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = (_V2HEAD.pack(len(meta), len(raws))
            + b"".join(_V2LEN.pack(r.nbytes) for r in raws))
    parts = [head, meta]
    parts.extend(raws)
    return parts, len(head) + len(meta), sum(r.nbytes for r in raws)


def _decode_v2_payload(payload: bytes):
    """Rebuild the message from a (decompressed) LRF2 payload.

    ndarrays come back as zero-copy views over ``payload``'s memory
    (read-only is fine: results are only ever read by fusion).
    """
    try:
        mv = memoryview(payload)
        meta_len, nbuf = _V2HEAD.unpack_from(mv, 0)
        off = _V2HEAD.size
        lens = [_V2LEN.unpack_from(mv, off + i * _V2LEN.size)[0]
                for i in range(nbuf)]
        off += nbuf * _V2LEN.size
        meta = mv[off:off + meta_len]
        if len(meta) != meta_len:
            raise FrameError("LRF2 payload truncated inside meta")
        off += meta_len
        buffers = []
        for n in lens:
            buf = mv[off:off + n]
            if len(buf) != n:
                raise FrameError("LRF2 payload truncated inside buffers")
            buffers.append(buf)
            off += n
        return pickle.loads(meta, buffers=buffers)
    except FrameError:
        raise
    except Exception as e:
        raise FrameError(f"corrupt LRF2 payload: {e}") from None


def _encode_frame_info(obj, compress: str = "auto", proto: int = 1
                       ) -> tuple:
    """Encode ``obj``; returns ``(parts, raw_len, inband, oob)``.

    ``parts[0]`` is the 16-byte header; the rest is the (possibly
    compressed) payload.  ``inband``/``oob`` split the raw payload into
    pickled bytes vs out-of-band ndarray buffer bytes (LRF1 is all
    in-band by construction).
    """
    if proto not in (1, 2):
        raise ValueError(f"unknown frame proto {proto} (LRF1 or LRF2)")
    if proto == 2:
        magic, version = MAGIC2, _VERSION2
        payload_parts, inband, oob = _encode_v2_parts(obj)
        raw_len = inband + oob
    else:
        magic, version = MAGIC, _VERSION
        payload_parts = [pickle.dumps(obj, protocol=5)]
        raw_len = inband = len(payload_parts[0])
        oob = 0
    codec = _pick_codec(compress, raw_len)
    if codec != CODEC_NONE:
        packed = _compress_parts(payload_parts, codec)
        if len(packed) < raw_len:
            payload_parts = [packed]
        else:                      # incompressible: ship raw, save the CPU
            codec = CODEC_NONE
    wire_len = sum(len(p) for p in payload_parts)
    header = _HEADER.pack(magic, version, codec, 0, raw_len, wire_len)
    return [header] + payload_parts, raw_len, inband, oob


def encode_frame(obj, compress: str = "auto", proto: int = 1) -> bytes:
    """Serialize ``obj`` into one self-describing frame.

    ``compress`` is a :data:`~repro_torch.runtime.tasks.COMPRESS_MODES` key:
    ``auto`` compresses payloads >= :data:`COMPRESS_MIN_BYTES` with lz4
    when available (fast path) else zlib, and keeps the compressed form
    only if it is actually smaller; ``zlib``/``lz4`` force the codec;
    ``none`` disables.  ``proto`` selects the frame protocol: 1 = LRF1
    (one pickle), 2 = LRF2 (pickle-free ndarray buffers).
    """
    parts, _, _, _ = _encode_frame_info(obj, compress, proto)
    return b"".join(parts)


def decode_frame(buf: bytes) -> tuple:
    """Parse one frame from ``buf``; returns ``(obj, consumed_bytes)``.

    Raises :class:`FrameError` on a short/garbage header, an unknown
    version or codec, a truncated payload, or a decompressed size that
    does not match the header's ``raw_len``.
    """
    if len(buf) < HEADER_SIZE:
        raise FrameError(f"truncated header: {len(buf)} < {HEADER_SIZE} "
                         f"bytes")
    magic, version, codec, _, raw_len, wire_len = _HEADER.unpack(
        buf[:HEADER_SIZE])
    if magic not in (MAGIC, MAGIC2):
        raise FrameError(f"bad magic {magic!r} (expected {MAGIC!r} or "
                         f"{MAGIC2!r})")
    if version != (_VERSION2 if magic == MAGIC2 else _VERSION):
        raise FrameError(f"unsupported frame version {version} for "
                         f"magic {magic!r}")
    if codec not in (CODEC_NONE, CODEC_ZLIB, CODEC_LZ4):
        raise FrameError(f"unknown codec {codec}")
    end = HEADER_SIZE + wire_len
    if len(buf) < end:
        raise FrameError(f"truncated payload: have {len(buf) - HEADER_SIZE} "
                         f"of {wire_len} bytes")
    try:
        payload = _decompress(bytes(buf[HEADER_SIZE:end]), codec)
    except FrameError:
        raise
    except Exception as e:
        # zlib raises zlib.error but lz4 raises RuntimeError: either way
        # corruption must surface as FrameError so the receiver re-dials
        # instead of dying on an unexpected exception type
        raise FrameError(f"corrupt compressed payload: {e}") from None
    if len(payload) != raw_len:
        raise FrameError(f"decompressed size {len(payload)} != header "
                         f"raw_len {raw_len}")
    if magic == MAGIC2:
        return _decode_v2_payload(payload), end
    try:
        obj = pickle.loads(payload)
    except Exception as e:
        raise FrameError(f"corrupt pickle payload: {e}") from None
    return obj, end


# -- socket plumbing ----------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Blocking read of exactly ``n`` bytes; EOFError on a closed peer.

    Never over-reads, so ``select`` on the raw socket stays an accurate
    "a frame (or part of one) is pending" signal — the property the
    worker's cancellable delay wait relies on.
    """
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise EOFError("connection closed by peer")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class _SockConn:
    """Duck-type of ``multiprocessing.Connection`` over a TCP socket.

    Provides exactly the surface the process backend's worker loop uses
    (``poll(timeout)`` / ``recv()`` / ``send(obj)`` / ``close()``), so
    :class:`~repro_torch.runtime.transport.process._WorkerLoop` runs unmodified
    over it.  Single-reader/single-writer per side; byte counters feed the
    transport's ``wire_stats``.
    """

    def __init__(self, sock: socket.socket, compress: str = "auto"):
        self.sock = sock
        self.compress = compress
        #: Negotiated frame protocol for *outbound* frames (1 until the
        #: hello exchange agrees on something newer); inbound frames are
        #: always self-describing, so both magics decode regardless.
        self.proto = 1
        self.frames_in = 0
        self.frames_out = 0
        self.raw_bytes_in = 0
        self.wire_bytes_in = 0
        self.raw_bytes_out = 0
        self.wire_bytes_out = 0
        self.inband_bytes_out = 0    # raw bytes that crossed the pickler
        self.oob_bytes_out = 0       # raw bytes lifted out of it (LRF2)

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            ready, _, _ = select.select([self.sock], [], [], timeout)
        except (OSError, ValueError):   # closed underneath us
            return True                 # let recv() raise the real error
        return bool(ready)

    def recv(self):
        header = _read_exact(self.sock, HEADER_SIZE)
        magic, version, codec, _, raw_len, wire_len = _HEADER.unpack(header)
        if not ((magic == MAGIC and version == _VERSION)
                or (magic == MAGIC2 and version == _VERSION2)):
            raise FrameError(f"bad frame header from peer: magic={magic!r} "
                             f"version={version}")
        payload = _read_exact(self.sock, wire_len)
        obj, _ = decode_frame(header + payload)
        self.frames_in += 1
        self.raw_bytes_in += raw_len
        self.wire_bytes_in += wire_len + HEADER_SIZE
        return obj

    def send(self, obj) -> None:
        parts, raw_len, inband, oob = _encode_frame_info(
            obj, self.compress, self.proto)
        # scatter-gather write: LRF2's ndarray buffers go to the kernel
        # straight from the arrays, never joined into one frame buffer
        vecs = [memoryview(p) for p in parts if len(p)]
        while vecs:
            sent = self.sock.sendmsg(vecs)
            while vecs and sent >= len(vecs[0]):
                sent -= len(vecs[0])
                vecs.pop(0)
            if sent and vecs:
                vecs[0] = vecs[0][sent:]
        self.frames_out += 1
        self.wire_bytes_out += sum(len(p) for p in parts)
        self.raw_bytes_out += raw_len
        self.inband_bytes_out += inband
        self.oob_bytes_out += oob

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:       # pragma: no cover - already torn down
            pass


# -- worker host (remote side) ------------------------------------------------

class _SocketWorkerLoop(_WorkerLoop):
    """The process backend's worker loop, pumping a socket connection.

    Adds only the heartbeat reply; rounds, purge watermarks, and
    drain-or-purge stops are handled by the base class, so the multi-host
    path cannot diverge from the single-host one.
    """

    def _handle(self, msg: tuple) -> None:
        if msg[0] == "ping":
            # echo the master's send instant and stamp our own monotonic
            # clock: the master estimates this host's clock offset as
            # t_worker - (t_send + t_recv)/2, error bounded by rtt/2.
            # A bare ("ping",) (older master) gets the bare legacy pong.
            if len(msg) > 1:
                self.conn.send(("pong", msg[1], clock()))
            else:
                self.conn.send(("pong",))
        else:
            super()._handle(msg)


class _ConnResults:
    """Adapter: the worker loop's result "queue" is the connection."""

    __slots__ = ("_conn",)

    def __init__(self, conn: _SockConn):
        self._conn = conn

    def put(self, item) -> None:
        self._conn.send(item)


def serve_worker_host(port: int = 0, host: str = "127.0.0.1", *,
                      once: bool = False,
                      announce: Callable[[str], None] = print,
                      metrics_port: Optional[int] = None) -> None:
    """Run one worker host: listen, serve master sessions until killed.

    A *session* starts with a ``("hello", worker_id, cfg, session_id,
    watermark)`` frame and ends with a ``stop`` (orderly: final stats are
    sent, state is discarded) or a dropped connection (crash/sever: state
    is *kept* so the master can reconnect and resume — its hello carries
    the same ``session_id`` and the authoritative purge watermark).  A
    hello with a new ``session_id`` always starts fresh, so a master that
    never said goodbye cannot leak its watermark or counters into the
    next run.

    ``port=0`` binds an ephemeral port; the chosen one is announced as
    ``LISTENING <host> <port>`` (the line :class:`LocalCluster` parses).
    ``once`` exits after the first orderly session — CI hygiene.

    ``metrics_port`` (``0`` = ephemeral) additionally serves this host's
    live counters (busy seconds, tasks done/purged, sessions served) as a
    Prometheus text endpoint on ``/metrics``, announced as
    ``METRICS <host> <port>`` — scrapeable mid-run, surviving between
    sessions with the last session's totals.
    """
    srv = socket.create_server((host, port))
    srv.listen(1)
    bound_port = srv.getsockname()[1]
    announce(f"LISTENING {host} {bound_port}")

    state = {"runner": None, "sessions": 0}
    metrics_server = None
    if metrics_port is not None:
        def _render() -> str:
            return telemetry.worker_metrics_text(
                state["runner"], sessions=state["sessions"])
        metrics_server, bound_metrics = telemetry.serve_metrics(
            _render, metrics_port, host)
        announce(f"METRICS {host} {bound_metrics}")

    session_id = None          # the session a reconnect may resume
    runner = None
    watermark = -1

    try:
        while True:
            try:
                raw_sock, _addr = srv.accept()
            except (KeyboardInterrupt, OSError):
                return
            raw_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _SockConn(raw_sock)
            try:
                hello = conn.recv()
                if not (isinstance(hello, tuple) and hello[0] == "hello"):
                    raise FrameError(f"expected hello, got {hello!r}")
                _, worker_id, cfg, sid, master_watermark, *rest = hello
                conn.compress = cfg.compress
                if rest:
                    # frame-protocol offer (6-element hello): agree on
                    # the newest protocol both sides speak.  The ack is
                    # sent *before* switching, so it is always readable
                    # by the offering master whatever was agreed.
                    agreed = max(1, min(2, int(rest[0])))
                    conn.send(("helloack", agreed))
                    conn.proto = agreed
                loop = _SocketWorkerLoop(worker_id, cfg, conn,
                                         _ConnResults(conn))
                if sid == session_id and runner is not None:
                    # same master reconnecting: keep its counters and
                    # watermark, pointing the kept runner's emit at the
                    # fresh connection
                    loop.runner = runner
                    runner._emit = loop._emit
                    loop.watermark = max(watermark, master_watermark)
                else:
                    # a new master (or one that lost its old host state):
                    # the loop's own fresh runner, master's watermark only
                    loop.watermark = master_watermark
                    state["sessions"] += 1
                runner = loop.runner
                state["runner"] = runner
                session_id = sid
                try:
                    loop.run()
                finally:
                    watermark = loop.watermark
                # run() returned: orderly stop — stats are already sent;
                # discard session state so the next hello starts clean
                session_id = None
                runner = None
                watermark = -1
                if once:
                    return
            except (EOFError, ConnectionError, FrameError, OSError):
                # dropped/garbled connection: keep session state for a
                # resuming master; anything queued died with the
                # connection and the master's purge watermark will cover
                # it
                pass
            except KeyboardInterrupt:
                return
            finally:
                conn.close()
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
        srv.close()


# -- master side --------------------------------------------------------------

class _WorkerLink:
    """Master-side state for one remote worker: socket, receiver thread,
    liveness, reconnect."""

    def __init__(self, transport: "SocketTransport", worker_id: int,
                 addr: str):
        self.transport = transport
        self.worker_id = worker_id
        host, _, port = addr.rpartition(":")
        self.host, self.port = host, int(port)
        self.conn: Optional[_SockConn] = None
        self.lock = threading.RLock()    # serializes send + reconnect
        self.gen = 0                     # bumped on every (re)connect
        self.last_seen = clock()
        self.dead: Optional[str] = None  # reason, once declared dead
        self.got_stats = threading.Event()
        self._closed_conn_stats = np.zeros(8, dtype=np.int64)
        # clock alignment: offset = worker_clock - master_clock, taken
        # from the minimum-RTT ping/pong exchange so the error is bounded
        # by rtt/2 (<= clock_rtt); refreshed by every heartbeat pong
        self.clock_offset = 0.0
        self.clock_rtt = float("inf")
        self.receiver = threading.Thread(
            target=self._receive, daemon=True,
            name=f"runtime-socket-recv-{worker_id}")

    # -- connection management ------------------------------------------------
    def _dial(self, timeout: float) -> _SockConn:
        deadline = clock() + timeout
        last_err: Exception = ConnectionError("never attempted")
        while clock() < deadline:
            try:
                sock = socket.create_connection(
                    (self.host, self.port),
                    timeout=max(0.1, deadline - clock()))
                # create_connection's timeout sticks to the socket: left
                # in place it turns every idle stretch on the receiver
                # into a spurious "recv: timed out" re-dial that kills
                # the in-flight rounds of the connection it replaces.
                # The dial bound must not outlive the dial.
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return _SockConn(sock, self.transport._cfg.compress)
            except OSError as e:
                last_err = e
                time.sleep(0.05)
        raise ConnectionError(
            f"worker {self.worker_id} at {self.host}:{self.port} "
            f"unreachable within {timeout}s: {last_err}")

    def connect(self, timeout: float) -> None:
        """Initial dial + hello (start path; raises on failure)."""
        with self.lock:
            self.conn = self._dial(timeout)
            self._hello()
            self.gen += 1
            self.last_seen = clock()

    def _hello(self) -> None:
        """Session hello + frame-protocol negotiation.

        ``cfg.frame_proto`` 0 (auto) or 2 offers LRF2 in a 6-element
        hello and *requires* the worker's ``helloack`` (sent as LRF1, so
        it is readable before any switch): a worker host that predates
        the offer never answers — its parse of the longer hello fails —
        and the bounded wait turns that into a clean ``ConnectionError``
        instead of a garbled-stream death mid-run.  ``frame_proto=1``
        sends the legacy 5-element hello: no ack, pure LRF1, the
        mixed-version escape hatch for one release.
        """
        t = self.transport
        offer = t._cfg.frame_proto or 2
        if offer <= 1:
            self.conn.send(("hello", self.worker_id, t._cfg, t._session,
                            t._watermark))
            self.conn.proto = 1
            return
        self.conn.send(("hello", self.worker_id, t._cfg, t._session,
                        t._watermark, offer))
        if not self.conn.poll(5.0):
            raise ConnectionError(
                f"worker {self.worker_id} at {self.host}:{self.port} did "
                f"not acknowledge the LRF{offer} offer within 5s — the "
                f"host likely predates frame protocol {offer}; upgrade "
                f"it or run with frame_proto=1")
        try:
            ack = self.conn.recv()
        except (EOFError, OSError, FrameError) as e:
            raise ConnectionError(
                f"worker {self.worker_id} at {self.host}:{self.port} "
                f"closed or garbled the hello exchange ({e}) — mixed "
                f"frame-protocol versions? upgrade the host or run with "
                f"frame_proto=1") from None
        if not (isinstance(ack, tuple) and ack[0] == "helloack"
                and int(ack[1]) in (1, 2)):
            raise ConnectionError(
                f"worker {self.worker_id} at {self.host}:{self.port} "
                f"answered the hello with {ack!r}, not a helloack")
        self.conn.proto = int(ack[1])

    def sync_clock(self, samples: int = 5) -> None:
        """Estimate this link's clock offset with synchronous ping/pong
        roundtrips (start path, before the receiver thread runs).

        Keeps the estimate from the minimum-RTT exchange:
        ``offset = t_worker - (t_send + t_recv)/2`` — symmetric-path
        assumption, so the alignment error is at most ``rtt/2``.
        Heartbeat pongs keep refreshing it for the rest of the run.
        """
        with self.lock:
            conn = self.conn
            if conn is None or self.dead is not None:
                return
            for _ in range(samples):
                try:
                    t_send = clock()
                    conn.send(("ping", t_send))
                    msg = conn.recv()
                    t_recv = clock()
                except (OSError, ConnectionError, EOFError, FrameError):
                    return          # liveness machinery will handle it
                if msg[0] != "pong" or len(msg) < 3:
                    continue
                rtt = t_recv - t_send
                if rtt < self.clock_rtt:
                    self.clock_rtt = rtt
                    self.clock_offset = msg[2] - 0.5 * (t_send + t_recv)
            self.last_seen = clock()

    def observe_pong(self, t_send: float, t_worker: float,
                     t_recv: float) -> float:
        """Fold one timestamped pong into the offset estimate; returns
        the exchange's RTT."""
        rtt = t_recv - t_send
        if 0.0 <= rtt < self.clock_rtt:
            self.clock_rtt = rtt
            self.clock_offset = t_worker - 0.5 * (t_send + t_recv)
        return rtt

    def _reconnect_or_fail(self, why: str) -> bool:
        """One bounded reconnect pass; returns True if the link is back.

        Runs under ``lock``.  The re-sent hello carries the session id
        and the current purge watermark, so a worker that kept state
        resumes exactly, and one that lost it starts clean *with the
        watermark already applied* — either way no purged round can
        execute after the reconnect.
        """
        if self.dead or self.transport._shutting_down:
            return False
        old = self.conn
        for attempt in range(self.transport.reconnect_attempts):
            try:
                self.conn = self._dial(self.transport.reconnect_timeout)
                self._hello()
                self.gen += 1
                self.last_seen = clock()
                if old is not None and old is not self.conn:
                    self._fold_stats(old)
                    old.close()
                tr = self.transport._tracer
                if tr is not None:
                    tr.emit(telemetry.RECONNECT, clock(),
                            worker=self.worker_id, label=why)
                return True
            except (OSError, ConnectionError, EOFError):
                # exponential backoff with jitter: a whole fleet re-dialing
                # a restarted host in lockstep (every link dropped at the
                # same instant) must not thundering-herd it
                delay = min(self.transport.reconnect_backoff_cap,
                            self.transport.reconnect_backoff * (2 ** attempt))
                time.sleep(delay * random.uniform(0.5, 1.5))
        self.mark_dead(f"connection lost ({why}); reconnect failed after "
                       f"{self.transport.reconnect_attempts} attempts")
        return False

    def mark_dead(self, reason: str) -> None:
        with self.lock:
            if self.dead is None:
                self.dead = reason
                tr = self.transport._tracer
                if tr is not None and reason != "shutdown":
                    tr.emit(telemetry.DEAD, clock(),
                            worker=self.worker_id, label=reason)
            if self.conn is not None:
                self.conn.close()

    def _fold_stats(self, conn: _SockConn) -> None:
        """Accumulate a retiring connection's byte counters (reconnects
        must not zero the run's wire totals)."""
        self._closed_conn_stats += (
            conn.frames_out, conn.raw_bytes_out, conn.wire_bytes_out,
            conn.frames_in, conn.raw_bytes_in, conn.wire_bytes_in,
            conn.inband_bytes_out, conn.oob_bytes_out)

    def stats_tuple(self) -> np.ndarray:
        """(frames_out, raw_out, wire_out, frames_in, raw_in, wire_in,
        inband_out, oob_out) over every connection this link has had."""
        with self.lock:
            total = self._closed_conn_stats.copy()
            conn = self.conn
            if conn is not None:
                total += (conn.frames_out, conn.raw_bytes_out,
                          conn.wire_bytes_out, conn.frames_in,
                          conn.raw_bytes_in, conn.wire_bytes_in,
                          conn.inband_bytes_out, conn.oob_bytes_out)
        return total

    # -- traffic --------------------------------------------------------------
    def send(self, msg: tuple) -> bool:
        """Send one frame; transparently reconnects once on a dropped
        connection.  Returns False (dropping the message) only for a
        dead link — the caller's next ``assert_alive`` reports it."""
        with self.lock:
            if self.dead is not None or self.conn is None:
                return False
            try:
                self.conn.send(msg)
                return True
            except (OSError, ConnectionError) as e:
                if self._reconnect_or_fail(f"send: {e}"):
                    try:
                        self.conn.send(msg)
                        return True
                    except (OSError, ConnectionError) as e2:
                        self.mark_dead(f"send failed twice: {e2}")
            return False

    def _receive(self) -> None:
        """Receiver loop: results/stats/pongs, EOF -> reconnect-or-fail."""
        t = self.transport
        while True:
            with self.lock:
                conn, gen = self.conn, self.gen
                if self.dead is not None:
                    return
            if conn is None:
                return
            try:
                msg = conn.recv()
            except FrameError as e:
                # garbled stream: cannot resynchronize mid-connection —
                # drop it and re-dial for a clean frame boundary
                with self.lock:
                    if t._shutting_down or self.dead is not None:
                        return
                    if self.gen == gen and not self._reconnect_or_fail(
                            f"garbled frame: {e}"):
                        return
                continue
            except (EOFError, OSError, ConnectionError) as e:
                with self.lock:
                    if t._shutting_down or self.dead is not None:
                        return
                    if self.gen != gen:   # send path already reconnected
                        continue
                    if not self._reconnect_or_fail(f"recv: {e}"):
                        return
                continue
            self.last_seen = clock()
            kind = msg[0]
            if kind == "result":
                wire, busy = msg[1], msg[2]
                result = TaskResult.from_wire(wire)
                off = self.clock_offset
                if off:
                    # rebase the remote finished_at onto the master's
                    # clock so fusion timestamps (fused_at, delay tables)
                    # stay comparable on genuinely multi-host clusters
                    result = dataclasses.replace(
                        result, finished_at=result.finished_at - off)
                with t._stats_lock:
                    t._busy[result.worker_id] = busy
                if len(msg) > 3 and t._tracer is not None:
                    # piggybacked worker events, rebased into master time
                    t._tracer.ingest(msg[3], shift=-off)
                t._sink(result)
            elif kind == "stats":
                worker_id, busy, done, purged = msg[1:5]
                with t._stats_lock:
                    t._busy[worker_id] = busy
                    t._done += done
                    t._purged += purged
                if len(msg) > 5 and t._tracer is not None:
                    t._tracer.ingest(msg[5], shift=-self.clock_offset)
                self.got_stats.set()
            elif kind == "pong":
                if len(msg) >= 3:   # timestamped: refresh clock estimate
                    rtt = self.observe_pong(msg[1], msg[2], self.last_seen)
                    if t._tracer is not None:
                        t._tracer.emit(telemetry.HEARTBEAT, self.last_seen,
                                       worker=self.worker_id, value=rtt)
            # unknown frames are ignored: forward compatibility


class SocketTransport(WorkerTransport):
    """``cfg.num_workers`` remote worker hosts over TCP (one per
    ``cfg.hosts`` entry), length-prefixed compressed frames, heartbeat
    liveness, reconnect-or-fail."""

    name = "socket"

    def __init__(self, cfg: RuntimeConfig,
                 sink: Callable[[TaskResult], None],
                 rng: Optional[np.random.Generator] = None,
                 tracer=None, *,
                 connect_timeout: float = 30.0,
                 heartbeat_interval: Optional[float] = None,
                 heartbeat_timeout: Optional[float] = None,
                 reconnect_attempts: Optional[int] = None,
                 reconnect_timeout: float = 1.0,
                 reconnect_backoff: Optional[float] = None,
                 reconnect_backoff_cap: Optional[float] = None):
        super().__init__(cfg, sink, rng, tracer)
        if cfg.compress == "lz4" and not have_lz4():
            raise ValueError("compress='lz4' but lz4 is not installed; "
                             "use 'zlib' or 'auto'")
        # liveness knobs default from the RuntimeConfig (runctl-settable);
        # explicit kwargs still override for tests that tighten one knob
        def _knob(kwarg, cfg_value):
            return cfg_value if kwarg is None else kwarg
        self.connect_timeout = connect_timeout
        self.heartbeat_interval = _knob(heartbeat_interval,
                                        cfg.heartbeat_interval)
        self.heartbeat_timeout = _knob(heartbeat_timeout,
                                       cfg.heartbeat_timeout)
        self.reconnect_attempts = _knob(reconnect_attempts,
                                        cfg.reconnect_attempts)
        self.reconnect_timeout = reconnect_timeout
        self.reconnect_backoff = _knob(reconnect_backoff,
                                       cfg.reconnect_backoff)
        self.reconnect_backoff_cap = _knob(reconnect_backoff_cap,
                                           cfg.reconnect_backoff_cap)
        self._retired_link_stats = np.zeros(8, dtype=np.int64)
        self._session = uuid.uuid4().hex
        self._watermark = -1          # highest purged dispatch seq
        self._busy = np.zeros(cfg.num_workers)
        self._done = 0
        self._purged = 0
        self._stats_lock = threading.Lock()
        self._started = False
        self._shutting_down = False
        self._stop_heartbeat = threading.Event()
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="runtime-socket-heartbeat")
        self.links = [_WorkerLink(self, p, addr)
                      for p, addr in enumerate(cfg.hosts)]

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        for link in self.links:
            link.connect(self.connect_timeout)
        for link in self.links:
            # synchronous roundtrips before the receiver competes for the
            # connection: every link starts with a bounded-error clock
            # offset, refreshed by heartbeat pongs for the rest of the run
            link.sync_clock()
        for link in self.links:
            link.receiver.start()
        self._heartbeat.start()
        self._started = True

    def shutdown(self, timeout: float = 10.0, *, drain: bool = False
                 ) -> None:
        self._shutting_down = True
        self._stop_heartbeat.set()
        if not self._started:
            for link in self.links:
                if link.conn is not None:
                    link.conn.close()
            return
        live = [ln for ln in self.links if ln.dead is None]
        for link in live:
            link.send(("stop", drain))
        deadline = clock() + timeout
        missing = []
        for link in live:
            if not link.got_stats.wait(max(0.0, deadline - clock())):
                missing.append(f"worker-{link.worker_id}@"
                               f"{link.host}:{link.port}")
        for link in self.links:
            link.mark_dead("shutdown")    # closes conns -> receivers exit
        self._heartbeat.join(timeout=timeout)
        leaked = []
        for link in self.links:
            if link.receiver.is_alive():
                link.receiver.join(timeout=timeout)
                if link.receiver.is_alive():
                    leaked.append(link.receiver.name)
        if leaked:
            raise RuntimeError(
                f"socket transport receiver thread(s) failed to stop "
                f"within {timeout}s: {leaked}")
        if missing:
            raise RuntimeError(
                f"worker host(s) never returned final stats within "
                f"{timeout}s: {missing}")

    # -- liveness -------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop_heartbeat.wait(self.heartbeat_interval):
            now = clock()
            for link in self.links:
                if link.dead is not None:
                    continue
                if now - link.last_seen > self.heartbeat_timeout:
                    link.mark_dead(
                        f"no frame for {now - link.last_seen:.1f}s "
                        f"(heartbeat timeout {self.heartbeat_timeout}s)")
                    continue
                link.send(("ping", clock()))

    def dead_worker_map(self) -> dict[int, str]:
        if not self._started or self._shutting_down:
            return {}
        return {ln.worker_id: f"socket-worker-{ln.worker_id}@"
                              f"{ln.host}:{ln.port} ({ln.dead})"
                for ln in self.links if ln.dead is not None}

    def _quarantine_worker(self, worker_id: int, reason: str) -> None:
        """Close the dead link (idempotent); its host may later come back
        through :meth:`try_readmit`'s fresh dial + hello resync."""
        self.links[worker_id].mark_dead(reason)

    def try_readmit(self) -> list[int]:
        """One quick re-dial pass over quarantined workers.

        A restarted (or revived) host accepts the dial; the fresh link's
        hello carries the run's session id and the authoritative purge
        watermark, so the host resumes (kept state) or starts clean with
        every purged round already dropped (lost state) — the same resync
        contract as a mid-run reconnect.  Unreachable hosts cost one
        short dial timeout each, so the caller rate-limits this.
        """
        readmitted = []
        for p in sorted(self.quarantined):
            old = self.links[p]
            link = _WorkerLink(self, p, f"{old.host}:{old.port}")
            try:
                link.connect(timeout=0.25)
            except (ConnectionError, OSError, EOFError, FrameError):
                if link.conn is not None:
                    link.conn.close()
                continue
            link.sync_clock(samples=2)
            link.receiver.start()
            # the retiring link's byte counters must survive replacement
            self._retired_link_stats += old.stats_tuple()
            old.mark_dead("superseded by readmitted link")
            self.links[p] = link
            self.quarantined.discard(p)
            readmitted.append(p)
        return readmitted

    # -- dispatch / purge -----------------------------------------------------
    def _send_slice(self, worker_id: int, ctx: RoundContext, first_task: int,
                    x: np.ndarray, y: np.ndarray,
                    delays: np.ndarray) -> None:
        wire = WireBatch(seq=ctx.seq, job_id=ctx.job_id,
                         round_idx=ctx.round_idx, first_task_id=first_task,
                         x=np.ascontiguousarray(x),
                         y=np.ascontiguousarray(y), delays=delays)
        # a dead worker's slice is dropped, not raised: redundancy may
        # still fuse the round, and assert_alive() reports the death at
        # the master's next liveness check either way
        self.links[worker_id].send(("round", wire))

    def _send_group(self, worker_id: int, seq: int, entries: list) -> None:
        levels = tuple(
            WireBatch(seq=seq, job_id=ctx.job_id, round_idx=ctx.round_idx,
                      first_task_id=lo, x=np.ascontiguousarray(x),
                      y=np.ascontiguousarray(y), delays=d)
            for ctx, lo, x, y, d in entries)
        group = WireGroup(seq=seq, job_id=levels[0].job_id,
                          base_round=levels[0].round_idx, levels=levels)
        self.links[worker_id].send(("group", group))

    def purge_round(self, ctx: RoundContext) -> None:
        ctx.purge()               # master side: fusion drops stale results
        if ctx.seq < 0:
            return                # never dispatched
        self._watermark = max(self._watermark, ctx.seq)
        for link in self.links:
            link.send(("purge", ctx.seq))

    def purge_level(self, ctx: RoundContext) -> None:
        ctx.purge()
        if ctx.seq < 0:
            return
        for link in self.links:
            link.send(("purgelvl", ctx.seq, ctx.round_idx))

    # -- occupancy / outcome counters ----------------------------------------
    @property
    def busy_seconds(self) -> np.ndarray:
        """Live values ride each result envelope (lagging a worker's
        current delay wait by one task); final stats make them exact."""
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

    @property
    def clock_sync(self) -> list:
        """Per-link clock alignment: ``{worker, host, offset_s, rtt_s}``.

        ``offset_s`` is the estimated ``worker_clock - master_clock``
        from the minimum-RTT ping/pong exchange; the estimation error is
        bounded by ``rtt_s`` (strictly, rtt/2 under symmetric paths).
        ``rtt_s`` is None only if a link never completed a timestamped
        exchange (dead before start finished).
        """
        return [{"worker": ln.worker_id,
                 "host": f"{ln.host}:{ln.port}",
                 "offset_s": ln.clock_offset,
                 "rtt_s": (ln.clock_rtt
                           if ln.clock_rtt != float("inf") else None)}
                for ln in self.links]

    @property
    def wire_stats(self) -> dict:
        """Aggregate frame/byte counters over all links.

        ``result_raw_bytes`` / ``result_wire_bytes`` are the result-path
        totals (worker -> master, pickles vs on-the-wire after
        compression); ``compression_ratio`` is raw/wire on that path
        (1.0 = incompressible or compression off).
        """
        total = self._retired_link_stats.copy()
        for link in self.links:
            total += link.stats_tuple()
        (frames_out, raw_out, bytes_out, frames_in, raw_in, wire_in,
         inband_out, oob_out) = (int(x) for x in total)
        protos = {link.conn.proto for link in self.links
                  if link.conn is not None}
        return {
            "transport": "socket",
            "frames_sent": frames_out,
            "dispatch_raw_bytes": raw_out,
            "dispatch_wire_bytes": bytes_out,
            # the zero-copy ledger: dispatch_copied_bytes crossed the
            # pickler (a serialization copy), dispatch_oob_bytes were
            # LRF2 out-of-band buffers shipped straight from the arrays
            "dispatch_copied_bytes": inband_out,
            "dispatch_oob_bytes": oob_out,
            "frame_proto": max(protos) if protos else 1,
            "frames_received": frames_in,
            "result_raw_bytes": raw_in,
            "result_wire_bytes": wire_in,
            "compression_ratio": (raw_in / wire_in) if wire_in else 1.0,
            "compress": self._cfg.compress,
            "lz4_available": have_lz4(),
        }

    # -- test hook ------------------------------------------------------------
    def sever_for_test(self, worker_id: int) -> None:
        """Forcibly drop one link's TCP connection (fault injection).

        Simulates a network sever: the socket is shut down under the
        link, so the next send/recv on it fails and the
        reconnect-or-fail path runs.  Test-only by contract.
        """
        conn = self.links[worker_id].conn
        if conn is not None:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:       # pragma: no cover - already down
                pass


# -- localhost test/bench harness ---------------------------------------------

class LocalCluster:
    """Spawn ``n`` worker hosts on localhost ports (subprocesses).

    The conformance suite's stand-in for a real multi-host cluster: each
    worker is a genuine OS process running ``runctl serve-worker`` (via
    ``python -m repro_torch.launch.worker_host``, with this package's
    ``src`` on its ``PYTHONPATH``), reachable only over TCP — and killable
    with SIGKILL for fault-injection tests.  Each host is a fresh
    interpreter that imports torch, so ``spawn_timeout`` covers that
    import too; the hosts compute on host BLAS and never touch CUDA.

    Use as a context manager::

        with LocalCluster(3) as cluster:
            cfg = RuntimeConfig(mu=(..,)*3, backend="socket",
                                hosts=cluster.hosts)
            ...

    Hosts serve sessions in a loop, so one cluster backs any number of
    sequential runs.
    """

    def __init__(self, num_workers: int, *, host: str = "127.0.0.1",
                 spawn_timeout: float = 60.0):
        self.host = host
        self.spawn_timeout = spawn_timeout
        self.processes: list[subprocess.Popen] = []
        self.hosts: tuple[str, ...] = ()
        src_root = pathlib.Path(__file__).resolve().parents[3]
        self._env = dict(os.environ)
        self._env["PYTHONPATH"] = (str(src_root) + os.pathsep
                                   + self._env.get("PYTHONPATH", ""))
        ports = []
        try:
            for _ in range(num_workers):
                self.processes.append(self._spawn(0))
            deadline = clock() + spawn_timeout
            for proc in self.processes:
                ports.append(self._await_announce(proc, deadline))
            self.hosts = tuple(f"{host}:{p}" for p in ports)
        except BaseException:
            self.close()
            raise

    def _spawn(self, port: int) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.worker_host",
             "--host", self.host, "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=self._env, text=True)

    def _await_announce(self, proc: subprocess.Popen,
                        deadline: float) -> int:
        """Parse one host's ``LISTENING`` line; returns its bound port.

        ``select`` before ``readline``: a wedged host that never prints
        its announce line must trip the timeout, not block forever (the
        announce is a single flushed line, so once readable it arrives
        whole).
        """
        ready, _, _ = select.select(
            [proc.stdout], [], [], max(0.0, deadline - clock()))
        if not ready:
            raise RuntimeError(
                f"worker host did not announce within "
                f"{self.spawn_timeout}s (exit code {proc.poll()})")
        line = proc.stdout.readline()
        if not line.startswith("LISTENING"):
            raise RuntimeError(
                f"worker host failed to start (said {line!r}, "
                f"exit code {proc.poll()})")
        return int(line.split()[2])

    def kill(self, index: int) -> None:
        """SIGKILL one worker host (the dead-node fault injection)."""
        self.processes[index].kill()
        self.processes[index].wait(timeout=10.0)

    def revive(self, index: int) -> None:
        """Restart a killed worker host on its original port.

        The chaos suite's recovery injection: the revived host is a fresh
        process with no session state, reachable at the same
        ``host:port`` the master was configured with — exactly the
        restart the transport's readmission path (re-dial + hello/
        watermark resync) exists for.
        """
        old = self.processes[index]
        if old.poll() is None:
            raise RuntimeError(f"worker host {index} is still alive; "
                               f"kill it before reviving")
        if old.stdout is not None:
            old.stdout.close()
        port = int(self.hosts[index].rpartition(":")[2])
        proc = self._spawn(port)
        try:
            self._await_announce(proc, clock() + self.spawn_timeout)
        except BaseException:
            proc.terminate()
            raise
        self.processes[index] = proc

    def close(self) -> None:
        for proc in self.processes:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.processes:
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:   # pragma: no cover
                proc.kill()
                proc.wait(timeout=10.0)
            if proc.stdout is not None:
                proc.stdout.close()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
