"""Port parity: structured tracing and the trace exporters
(``repro_torch.runtime.telemetry``, ``repro_torch.runtime.trace_export``).

The cases of the JAX package's ``tests/test_telemetry.py`` on the port,
and one more block (:class:`TestReferenceParity`): one seeded run traced
by both packages yields the same event kinds, the same Chrome-trace
tracks and categories and the same Prometheus metric names; ``runctl
--trace/--trace-jsonl/--timeline/--metrics-out`` write what the JAX
package's ``runctl`` writes; and ``runctl serve-worker --metrics-port``
serves live counters from a worker host process.

The reference file's own summary follows.

Structured tracing: tracer units, exporters, and cross-backend
conformance.

The conformance half runs real traced workloads over every transport
({thread, process, socket} — socket against a live LocalCluster) and
checks the one property that makes the trace trustworthy: the event log
*reconciles exactly* with the run's aggregate counters.  Every
``tasks_done`` increment has a ``done`` task span, every purge a
``purged`` one, every stale result a ``stale`` instant, every dispatched
round exactly one round span — over any backend, including events that
crossed a process or TCP boundary to get here.
"""

import json
import os
import pathlib
import select
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.runtime as jr  # noqa: E402
from repro.launch import runctl as ref_runctl  # noqa: E402
from repro.runtime import trace_export as ref_export  # noqa: E402
from repro_torch.launch import runctl  # noqa: E402
from repro_torch.runtime import RuntimeConfig, run_jobs  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime import trace_export  # noqa: E402
from repro_torch.runtime.telemetry import TraceEvent, Tracer  # noqa: E402
from repro_torch.runtime.transport.socket_host import (  # noqa: E402
    LocalCluster)

ROOT = pathlib.Path(__file__).resolve().parent.parent

MU3 = (400.0, 650.0, 380.0)
BACKENDS_FULL = ("thread", "process", "socket")


@pytest.fixture(scope="module")
def socket_cluster():
    with LocalCluster(len(MU3)) as cluster:
        yield cluster


@pytest.fixture
def bcfg(request):
    def make(backend, **kw):
        kw.setdefault("mu", MU3)
        kw.setdefault("trace", True)
        if backend == "socket":
            kw.setdefault(
                "hosts", request.getfixturevalue("socket_cluster").hosts)
        return RuntimeConfig(backend=backend, **kw)

    return make


class TestTracer:
    def test_emit_and_sorted_events(self):
        tr = Tracer()
        tr.emit(telemetry.ENCODE, 2.0, dur=0.5, job=1, round=0)
        tr.emit(telemetry.DISPATCH, 1.0, job=1, round=0, value=7.0)
        evs = tr.events()
        assert [e.kind for e in evs] == ["dispatch", "encode"]  # time order
        assert evs[1].dur == 0.5 and evs[0].value == 7.0
        assert tr.events() == evs            # non-destructive

    def test_drain_takes_and_clears(self):
        tr = Tracer()
        tr.emit(telemetry.TASK, 1.0, dur=0.1, label="done")
        assert len(tr.drain()) == 1
        assert tr.drain() == [] and tr.events() == []

    def test_ring_overflow_keeps_newest_and_counts_drops(self):
        tr = Tracer(capacity=4)
        for i in range(10):
            tr.emit(telemetry.RESULT, float(i))
        evs = tr.events()
        assert len(evs) == 4 and tr.dropped == 6
        assert [e.t for e in evs] == [6.0, 7.0, 8.0, 9.0]   # oldest evicted

    def test_ingest_rebases_remote_clock(self):
        tr = Tracer()
        remote = [tuple(TraceEvent(telemetry.TASK, 100.0, 0.25, 3, 1, 2, 0,
                                   0.0, "done"))]
        tr.ingest(remote, shift=-90.0)
        ev = tr.events()[0]
        assert ev.t == pytest.approx(10.0)
        assert (ev.dur, ev.job, ev.round, ev.task, ev.label) == \
            (0.25, 3, 1, 2, "done")
        tr.ingest(remote)                    # shift=0 fast path
        assert tr.events()[-1].t == pytest.approx(100.0)

    def test_threads_do_not_interleave_rings(self):
        tr = Tracer()
        n = 500

        def record(worker):
            for i in range(n):
                tr.emit(telemetry.TASK, float(i), worker=worker)

        threads = [threading.Thread(target=record, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        evs = tr.events()
        assert len(evs) == 4 * n and tr.dropped == 0
        counts = np.bincount([e.worker for e in evs])
        assert counts.tolist() == [n] * 4

    def test_taxonomy_is_partitioned(self):
        assert not (telemetry.SPAN_KINDS & telemetry.INSTANT_KINDS)
        assert telemetry.EVENT_KINDS == \
            telemetry.SPAN_KINDS | telemetry.INSTANT_KINDS


class TestExporters:
    @pytest.fixture(scope="class")
    def traced(self):
        cfg = RuntimeConfig(mu=MU3, arrival_rate=60.0, complexity=4.0,
                            straggler="none", trace=True, seed=0,
                            backend="thread")
        res, _ = run_jobs(cfg, 4, K=16, M=4, N=4, verify=False)
        return res

    def test_chrome_trace_is_perfetto_shaped(self, traced):
        chrome = trace_export.chrome_trace(traced)
        json.dumps(chrome)                   # serializable end to end
        evs = chrome["traceEvents"]
        assert chrome["displayTimeUnit"] == "ms"
        phases = {e["ph"] for e in evs}
        assert phases <= {"M", "X", "i"}
        spans = [e for e in evs if e["ph"] == "X"]
        assert spans and all(e["dur"] >= 0.0 and e["ts"] >= 0.0
                             for e in spans)
        assert all(e["s"] == "t" for e in evs if e["ph"] == "i")
        names = [e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "process_name"]
        assert names[0].startswith("master")
        assert len(names) == 1 + len(MU3)    # master + one per worker
        # worker task spans live in per-worker processes, master gets none
        assert all(e["pid"] >= 1 for e in evs if e.get("cat") == "task")

    def test_jsonl_round_trips(self, traced):
        lines = list(trace_export.jsonl_lines(traced))
        assert len(lines) == len(traced.trace_events)
        recs = [json.loads(line) for line in lines]
        assert all(r["t"] >= 0.0 for r in recs)
        assert {r["kind"] for r in recs} <= telemetry.EVENT_KINDS

    def test_prometheus_snapshot_counters(self, traced):
        text = trace_export.prometheus_snapshot(traced)
        assert text.endswith("\n")
        assert f'repro_tasks_done_total{{backend="thread"}} ' \
               f"{traced.tasks_done}" in text
        assert f'repro_rounds_total{{backend="thread"}} ' \
               f"{traced.stage_rounds}" in text
        hist = traced.release_histogram()
        assert f'repro_jobs_released_total{{resolution="-1"}} ' \
               f"{int(hist[0])}" in text

    def test_format_timeline_rows(self, traced):
        art = trace_export.format_timeline(traced, width=60)
        lines = art.splitlines()
        assert lines[0].startswith("timeline")
        assert lines[1].lstrip().startswith("master")
        assert len(lines) == 2 + len(MU3)    # header + master + workers
        assert any("#" in line for line in lines[2:])

    def test_untraced_result_rejected(self):
        cfg = RuntimeConfig(mu=MU3, arrival_rate=60.0, complexity=4.0,
                            straggler="none", seed=0, backend="thread")
        res, _ = run_jobs(cfg, 2, K=16, M=4, N=4, verify=False)
        assert res.trace_events is None and res.tasks_done > 0
        with pytest.raises(ValueError, match="trace"):
            trace_export.chrome_trace(res)
        # prometheus reads counters only: works untraced by design
        assert "repro_tasks_done_total" in \
            trace_export.prometheus_snapshot(res)


@pytest.mark.parametrize("backend", BACKENDS_FULL)
class TestTraceConformance:
    """Same schema, exact counter reconciliation, over every transport."""

    def test_events_reconcile_with_counters(self, backend, bcfg):
        cfg = bcfg(backend, arrival_rate=60.0, complexity=4.0,
                   straggler="none", seed=0)
        res, _ = run_jobs(cfg, 5, K=16, M=4, N=4, verify=False)
        evs = res.trace_events
        assert evs is not None and res.trace_dropped == 0
        assert {e.kind for e in evs} <= telemetry.EVENT_KINDS
        assert all(isinstance(e, TraceEvent) for e in evs)

        tasks = [e for e in evs if e.kind == telemetry.TASK]
        assert sum(e.label == "done" for e in tasks) == res.tasks_done
        assert sum(e.label == "purged" for e in tasks) == res.tasks_purged
        assert sum(e.kind == telemetry.STALE for e in evs) == \
            res.stale_results
        rounds = [e for e in evs if e.kind == telemetry.ROUND]
        assert len(rounds) == res.stage_rounds
        assert sum(e.kind == telemetry.DISPATCH for e in evs) == \
            res.stage_rounds
        # accepted arrivals: k per fused round, all within the run window
        fused = sum(e.kind == telemetry.FUSED for e in evs)
        arrivals = sum(e.kind == telemetry.RESULT for e in evs)
        assert arrivals == fused * cfg.k
        assert sum(e.kind == telemetry.JOB for e in evs) == res.num_jobs
        # the merged log is time-sorted and anchored at the run start
        ts = [e.t for e in evs]
        assert ts == sorted(ts)
        assert all(e.t - res.trace_t0 > -1e-4 for e in evs)

    def test_purged_task_spans_close_purged_not_fused(self, backend, bcfg):
        """A deadline-purged round's tasks must close as ``purged`` —
        never as ``fused``/``done`` — and the purged round span must say
        so too."""
        cfg = bcfg(backend, arrival_rate=14.0, complexity=8.0,
                   deadline=0.030, straggler="stall", stall_workers=(2,),
                   stall_seconds=2.0, seed=0)
        res, _ = run_jobs(cfg, 10, K=16, M=4, N=4, verify=False)
        evs = res.trace_events
        assert res.tasks_purged > 0          # the stall really binds
        tasks = [e for e in evs if e.kind == telemetry.TASK]
        assert {e.label for e in tasks} <= {"done", "purged"}
        assert sum(e.label == "purged" for e in tasks) == res.tasks_purged
        rounds = [e for e in evs if e.kind == telemetry.ROUND]
        purged_rounds = {(e.job, e.round) for e in rounds
                         if e.label == "purged"}
        assert purged_rounds                 # some round missed its window
        # a round span closes fused or purged, never both
        fused_keys = {(e.job, e.round) for e in evs
                      if e.kind == telemetry.FUSED}
        assert not (purged_rounds & fused_keys)

    def test_worker_spans_cover_busy_time(self, backend, bcfg):
        """Per-worker span durations sum to that worker's busy-seconds
        counter (the trace is the counter, itemized)."""
        cfg = bcfg(backend, arrival_rate=60.0, complexity=4.0,
                   straggler="none", seed=1)
        res, _ = run_jobs(cfg, 5, K=16, M=4, N=4, verify=False)
        spans = [e for e in res.trace_events if e.kind == telemetry.TASK]
        for w, busy in enumerate(res.worker_busy):
            mine = sum(e.dur for e in spans if e.worker == w)
            assert mine == pytest.approx(float(busy), rel=0.05, abs=2e-3)

    def test_untraced_run_carries_no_events(self, backend, bcfg):
        cfg = bcfg(backend, arrival_rate=60.0, complexity=4.0,
                   straggler="none", trace=False, seed=0)
        res, _ = run_jobs(cfg, 3, K=16, M=4, N=4, verify=False)
        assert res.trace_events is None
        assert res.trace_dropped == 0
        assert res.tasks_done > 0            # counters still flow untraced


class TestSocketClockAlignment:
    """The cross-host half of the tentpole: remote monotonic clocks land
    on the master timeline with error bounded by the measured RTT."""

    def test_offsets_bounded_and_reported(self, bcfg):
        cfg = bcfg("socket", arrival_rate=60.0, complexity=4.0,
                   straggler="none", seed=0)
        res, _ = run_jobs(cfg, 5, K=16, M=4, N=4, verify=False)
        sync = res.clock_sync
        assert sync is not None and len(sync) == len(MU3)
        for row in sync:
            assert row["rtt_s"] is not None and row["rtt_s"] > 0.0
            # same machine, same monotonic clock: the estimated offset is
            # pure protocol error, bounded by the loopback RTT
            assert abs(row["offset_s"]) <= max(row["rtt_s"], 1e-3)

    def test_remote_task_spans_sit_inside_round_spans(self, bcfg):
        """After rebasing, a worker's task span for round r cannot start
        before the master dispatched r (up to the alignment error)."""
        cfg = bcfg("socket", arrival_rate=60.0, complexity=4.0,
                   straggler="none", seed=0)
        res, _ = run_jobs(cfg, 5, K=16, M=4, N=4, verify=False)
        slack = max(max(r["rtt_s"] or 0.0 for r in res.clock_sync), 1e-3)
        dispatch_at = {(e.job, e.round): e.t for e in res.trace_events
                       if e.kind == telemetry.DISPATCH}
        tasks = [e for e in res.trace_events if e.kind == telemetry.TASK]
        assert tasks
        for e in tasks:
            t_disp = dispatch_at.get((e.job, e.round))
            if t_disp is not None:
                assert e.t >= t_disp - slack

    def test_metrics_endpoint_serves_live_counters(self):
        """`runctl serve-worker --metrics-port`: /metrics scrapes reflect
        the runner's live counters in Prometheus text format."""
        import urllib.request

        class _Runner:
            worker_id = 3
            busy_seconds = 1.25
            tasks_done = 42
            tasks_purged = 7

        server, port = telemetry.serve_metrics(
            lambda: telemetry.worker_metrics_text(_Runner(), sessions=2))
        try:
            url = f"http://127.0.0.1:{port}/metrics"
            body = urllib.request.urlopen(url, timeout=5).read().decode()
            assert 'repro_worker_tasks_done_total{worker="3"} 42' in body
            assert 'repro_worker_sessions_total{worker="3"} 2' in body
            assert 'repro_worker_busy_seconds{worker="3"} 1.250000' in body
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/nope", timeout=5)
        finally:
            server.shutdown()


# -- parity with the JAX package's exporters ----------------------------------

#: the deterministic event kinds of a straggler-free run: one per job,
#: round, dispatch and fusion, whichever worker finishes first
COUNTED_KINDS = (telemetry.JOB, telemetry.ROUND, telemetry.DISPATCH,
                 telemetry.FUSED)


def _metric_names(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def _chrome_shape(chrome):
    evs = chrome["traceEvents"]
    meta = sorted((e["pid"], e.get("tid", 0), e["name"], e["args"]["name"])
                  for e in evs if e["ph"] == "M")
    cats = {e.get("cat") for e in evs if e["ph"] != "M"}
    return meta, cats


class TestReferenceParity:
    @pytest.fixture(scope="class")
    def both(self):
        kw = dict(mu=MU3, arrival_rate=60.0, complexity=4.0,
                  straggler="none", trace=True, seed=0, backend="thread")
        ours, _ = run_jobs(RuntimeConfig(**kw), 4, K=16, M=4, N=4,
                           verify=False)
        theirs, _ = jr.run_jobs(jr.RuntimeConfig(**kw), 4, K=16, M=4, N=4,
                                verify=False)
        return ours, theirs

    def test_taxonomy_matches_reference(self):
        assert telemetry.SPAN_KINDS == jr.telemetry.SPAN_KINDS
        assert telemetry.INSTANT_KINDS == jr.telemetry.INSTANT_KINDS

    def test_same_event_kinds_and_counts(self, both):
        ours, theirs = both
        assert ({e.kind for e in ours.trace_events}
                == {e.kind for e in theirs.trace_events})
        for kind in COUNTED_KINDS:
            assert (sum(e.kind == kind for e in ours.trace_events)
                    == sum(e.kind == kind for e in theirs.trace_events))

    def test_chrome_trace_tracks_match_reference(self, both):
        ours, theirs = both
        assert (_chrome_shape(trace_export.chrome_trace(ours))
                == _chrome_shape(ref_export.chrome_trace(theirs)))

    def test_prometheus_metric_names_match_reference(self, both):
        ours, theirs = both
        text = trace_export.prometheus_snapshot(ours)
        assert _metric_names(text) == _metric_names(
            ref_export.prometheus_snapshot(theirs))
        assert f'repro_tasks_done_total{{backend="thread"}} ' \
               f"{ours.tasks_done}" in text

    def test_jsonl_fields_match_reference(self, both):
        ours, theirs = both
        mine = [json.loads(x) for x in trace_export.jsonl_lines(ours)]
        ref = [json.loads(x) for x in ref_export.jsonl_lines(theirs)]
        assert set(mine[0]) == set(ref[0])
        assert ({r["kind"] for r in mine} == {r["kind"] for r in ref})


class TestRunctlTraceOutputs:
    """``runctl --trace/--trace-jsonl/--timeline/--metrics-out`` on the
    port, beside the JAX package's ``runctl`` on the same flags."""

    FLAGS = ["--jobs", "4", "--mu", "400,650,380", "--straggler", "none",
             "--complexity", "4", "--arrival-rate", "60", "--K", "16",
             "--M", "4", "--N", "4", "--backend", "thread", "--timeline"]

    def _run(self, main, tmp, capsys):
        out = {k: tmp / f"{k}" for k in ("trace", "jsonl", "prom", "json")}
        assert main(self.FLAGS + [
            "--trace", str(out["trace"]), "--trace-jsonl", str(out["jsonl"]),
            "--metrics-out", str(out["prom"]),
            "--json", str(out["json"])]) == 0
        return out, capsys.readouterr().out

    def test_outputs_match_reference(self, tmp_path, capsys):
        ours, printed = self._run(runctl.main, tmp_path / "port", capsys)
        theirs, _ = self._run(ref_runctl.main, tmp_path / "ref", capsys)
        chrome = json.loads(ours["trace"].read_text())
        assert (_chrome_shape(chrome)
                == _chrome_shape(json.loads(theirs["trace"].read_text())))
        lines = ours["jsonl"].read_text().splitlines()
        assert lines and {json.loads(x)["kind"] for x in lines} \
            <= telemetry.EVENT_KINDS
        assert _metric_names(ours["prom"].read_text()) == \
            _metric_names(theirs["prom"].read_text())
        summary = json.loads(ours["json"].read_text())
        assert summary["backend"] == "thread"
        assert summary["max_verify_rel_error"] < 1e-9
        # the ASCII Gantt: header, master row, one row per worker
        timeline = [x for x in printed.splitlines()
                    if x.startswith("timeline")]
        assert timeline, printed


def _read_line(proc, timeout=60.0):
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, "worker host printed nothing"
    return proc.stdout.readline()


def _scrape(url):
    body = urllib.request.urlopen(url, timeout=10).read().decode()
    return {line.split("{")[0]: float(line.split()[-1])
            for line in body.splitlines()
            if line and not line.startswith("#")}


def test_serve_worker_metrics_port_serves_live_counters():
    """``runctl serve-worker --metrics-port 0`` in its own process: it
    announces both ports, its /metrics endpoint answers in the Prometheus
    text format, and after one master session on the ``socket`` backend
    it counts that session and the tasks it ran."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.runctl", "serve-worker",
         "--port", "0", "--metrics-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True)
    try:
        listening = _read_line(proc).split()
        metrics = _read_line(proc).split()
        assert listening[0] == "LISTENING" and int(listening[2]) > 0
        assert metrics[0] == "METRICS"
        url = f"http://{metrics[1]}:{metrics[2]}/metrics"
        before = _scrape(url)
        assert before["repro_worker_sessions_total"] == 0
        assert before["repro_worker_tasks_done_total"] == 0
        cfg = RuntimeConfig(mu=(400.0,), n1=1, n2=1, omega=1.0,
                            straggler="none", backend="socket",
                            hosts=(f"{listening[1]}:{listening[2]}",))
        res, _ = run_jobs(cfg, 2, K=16, M=4, N=4, verify=True)
        assert np.nanmax(res.verify_errors) < 1e-9
        after = _scrape(url)
        assert after["repro_worker_sessions_total"] == 1
        assert after["repro_worker_tasks_done_total"] == res.tasks_done > 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
