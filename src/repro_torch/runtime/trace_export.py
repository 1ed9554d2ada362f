"""Trace exporters: Chrome trace-event JSON, JSONL, Prometheus, ASCII Gantt.

All exporters consume a traced
:class:`~repro_torch.runtime.metrics.RuntimeResult` (``cfg.trace=True`` →
``result.trace_events`` is a time-sorted
:class:`~repro_torch.runtime.telemetry.TraceEvent` list, already rebased
onto the master's monotonic clock; ``result.trace_t0`` anchors t=0 at the
run start).

* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome trace-event
  format (the ``traceEvents`` JSON object).  Loads directly in Perfetto
  (https://ui.perfetto.dev → *Open trace file*) or ``chrome://tracing``:
  pid 0 is the master with one named track per pipeline stage (rounds,
  encode, decode, fusion arrivals, control), pid ``1 + worker`` is one
  track per worker/host with its task spans.
* :func:`write_jsonl` / :func:`jsonl_lines` — one JSON object per event,
  for ad-hoc ``jq``/pandas analysis.
* :func:`prometheus_snapshot` — Prometheus text-format dump of the run's
  final counters (the master-side complement of the live
  ``runctl serve-worker --metrics-port`` endpoint).
* :func:`format_timeline` — ASCII Gantt for terminal triage: one row per
  worker plus a master round-span row, no external viewer needed.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, Iterator, List

from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import SPAN_KINDS, TraceEvent

__all__ = ["chrome_trace", "write_chrome_trace", "jsonl_lines",
           "write_jsonl", "prometheus_snapshot", "format_timeline"]

#: Master-track (pid 0) thread layout: kind -> (tid, track name).  Worker
#: task spans go to pid 1 + worker instead.
_MASTER_TRACKS = {
    telemetry.JOB: (0, "jobs"),
    telemetry.PREP: (1, "prep"),
    telemetry.ENCODE: (2, "encode"),
    telemetry.DISPATCH: (3, "dispatch"),
    telemetry.ROUND: (4, "rounds"),
    telemetry.DECODE: (5, "decode"),
    telemetry.RESULT: (6, "fusion"),
    telemetry.FUSED: (6, "fusion"),
    telemetry.STALE: (6, "fusion"),
    telemetry.RESOLUTION: (7, "releases"),
    telemetry.RETUNE: (8, "control"),
    telemetry.HEARTBEAT: (9, "transport"),
    telemetry.RECONNECT: (9, "transport"),
    telemetry.DEAD: (9, "transport"),
}


def _events_of(result) -> List[TraceEvent]:
    events = getattr(result, "trace_events", None)
    if events is None:
        raise ValueError(
            "result carries no trace events — run with cfg.trace=True "
            "(runctl --trace/--timeline sets it)")
    return events


def _event_name(ev: TraceEvent) -> str:
    if ev.kind == telemetry.TASK:
        return f"task {ev.task} (j{ev.job} r{ev.round})"
    if ev.kind == telemetry.ROUND:
        return f"round j{ev.job}.{ev.round}"
    if ev.kind == telemetry.JOB:
        return f"job {ev.job}"
    if ev.kind == telemetry.RESOLUTION:
        return f"res-{int(ev.value)}"
    return ev.kind


def chrome_trace(result) -> dict:
    """Build the Chrome trace-event object for a traced run."""
    events = _events_of(result)
    t0 = getattr(result, "trace_t0", 0.0)
    hosts = {int(row["worker"]): str(row.get("host", ""))
             for row in (getattr(result, "clock_sync", None) or [])}

    out: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": f"master ({getattr(result, 'backend', '?')})"}},
    ]
    for tid, track in sorted(set(_MASTER_TRACKS.values())):
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": track}})
    seen_workers = set()

    for ev in events:
        ts = (ev.t - t0) * 1e6
        if ev.kind == telemetry.TASK:
            pid, tid = 1 + ev.worker, 0
            if ev.worker not in seen_workers:
                seen_workers.add(ev.worker)
                name = f"worker-{ev.worker}"
                if hosts.get(ev.worker):
                    name += f" ({hosts[ev.worker]})"
                out.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})
        else:
            pid, tid = 0, _MASTER_TRACKS.get(ev.kind, (10, "misc"))[0]
        args = {"job": ev.job, "round": ev.round}
        if ev.task >= 0:
            args["task"] = ev.task
        if ev.worker >= 0:
            args["worker"] = ev.worker
        if ev.value:
            args["value"] = ev.value
        if ev.label:
            args["label"] = ev.label
        rec = {"name": _event_name(ev), "cat": ev.kind, "pid": pid,
               "tid": tid, "ts": ts, "args": args}
        if ev.kind in SPAN_KINDS:
            rec["ph"] = "X"
            rec["dur"] = ev.dur * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"   # thread-scoped instant
        out.append(rec)

    meta = {
        "backend": getattr(result, "backend", None),
        "trace_dropped": getattr(result, "trace_dropped", 0),
        "clock_sync": getattr(result, "clock_sync", None),
    }
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(path, result) -> pathlib.Path:
    """Write :func:`chrome_trace` JSON to ``path`` (Perfetto-loadable)."""
    path = pathlib.Path(path)
    path.write_text(json.dumps(chrome_trace(result)))
    return path


def jsonl_lines(result) -> Iterator[str]:
    """One compact JSON object per event, times in seconds from run
    start."""
    t0 = getattr(result, "trace_t0", 0.0)
    for ev in _events_of(result):
        rec = {"kind": ev.kind, "t": round(ev.t - t0, 9)}
        if ev.dur:
            rec["dur"] = round(ev.dur, 9)
        for field in ("job", "round", "task", "worker"):
            v = getattr(ev, field)
            if v >= 0:
                rec[field] = v
        if ev.value:
            rec["value"] = ev.value
        if ev.label:
            rec["label"] = ev.label
        yield json.dumps(rec)


def write_jsonl(path, result) -> pathlib.Path:
    path = pathlib.Path(path)
    with path.open("w") as fh:
        for line in jsonl_lines(result):
            fh.write(line + "\n")
    return path


def prometheus_snapshot(result) -> str:
    """Prometheus text-format dump of a finished run's counters.

    Works on any :class:`~repro_torch.runtime.metrics.RuntimeResult` (tracing
    not required) — it reads the aggregate counters, not the event log.
    """
    backend = getattr(result, "backend", "unknown")
    lines = [
        "# HELP repro_run_wall_seconds Run duration (last service end - "
        "run start).",
        "# TYPE repro_run_wall_seconds gauge",
        f'repro_run_wall_seconds{{backend="{backend}"}} '
        f"{result.wall_elapsed:.6f}",
        "# HELP repro_jobs_total Jobs executed.",
        "# TYPE repro_jobs_total counter",
        f'repro_jobs_total{{backend="{backend}"}} {len(result.arrivals)}',
        "# HELP repro_jobs_terminated_total Jobs cut off at the deadline "
        "(paper §IV termination).",
        "# TYPE repro_jobs_terminated_total counter",
        f'repro_jobs_terminated_total{{backend="{backend}"}} '
        f"{int(result.terminated.sum())}",
        "# HELP repro_rounds_total Rounds dispatched.",
        "# TYPE repro_rounds_total counter",
        f'repro_rounds_total{{backend="{backend}"}} {result.stage_rounds}',
        "# HELP repro_tasks_done_total Coded tasks computed across all "
        "workers.",
        "# TYPE repro_tasks_done_total counter",
        f'repro_tasks_done_total{{backend="{backend}"}} '
        f"{result.tasks_done}",
        "# HELP repro_tasks_purged_total Tasks reclaimed by purges.",
        "# TYPE repro_tasks_purged_total counter",
        f'repro_tasks_purged_total{{backend="{backend}"}} '
        f"{result.tasks_purged}",
        "# HELP repro_stale_results_total Results that arrived after "
        "their round fused or was purged.",
        "# TYPE repro_stale_results_total counter",
        f'repro_stale_results_total{{backend="{backend}"}} '
        f"{result.stale_results}",
    ]
    lines += [
        "# HELP repro_worker_busy_seconds Per-worker occupancy (delay + "
        "compute).",
        "# TYPE repro_worker_busy_seconds counter",
    ]
    for p, busy in enumerate(result.worker_busy):
        lines.append(f'repro_worker_busy_seconds{{worker="{p}"}} '
                     f"{float(busy):.6f}")
    if result.stage_seconds:
        lines += [
            "# HELP repro_stage_seconds_total Master pipeline seconds by "
            "stage.",
            "# TYPE repro_stage_seconds_total counter",
        ]
        for stage, v in result.stage_seconds.items():
            lines.append(f'repro_stage_seconds_total{{stage="{stage}"}} '
                         f"{v:.6f}")
    hist = result.release_histogram()
    lines += [
        "# HELP repro_jobs_released_total Jobs by highest released "
        'resolution (resolution="-1" = none).',
        "# TYPE repro_jobs_released_total counter",
    ]
    for slot, count in enumerate(hist):
        lines.append(
            f'repro_jobs_released_total{{resolution="{slot - 1}"}} '
            f"{int(count)}")
    for row in (getattr(result, "clock_sync", None) or []):
        lines.append(
            f'repro_clock_offset_seconds{{worker="{row["worker"]}"}} '
            f"{row['offset_s']:.9f}")
        if row.get("rtt_s") is not None:   # None = link never synced
            lines.append(
                f'repro_clock_rtt_seconds{{worker="{row["worker"]}"}} '
                f"{row['rtt_s']:.9f}")
    return "\n".join(lines) + "\n"


def _paint(row: list, lo: float, scale: float, t_from: float, t_to: float,
           ch: str) -> None:
    a = int((t_from - lo) * scale)
    b = max(a + 1, int((t_to - lo) * scale))
    for i in range(max(a, 0), min(b, len(row))):
        row[i] = ch


def format_timeline(result, width: int = 72) -> str:
    """ASCII Gantt of a traced run: master rounds + per-worker task spans.

    Legend: ``#`` task compute/delay that completed, ``x`` purged task
    occupancy, ``=`` a round span on the master row (``!`` if the round
    was purged unfused), ``.`` idle.
    """
    events = _events_of(result)
    if not events:
        return "(trace is empty)"
    t0 = getattr(result, "trace_t0", 0.0) or min(ev.t for ev in events)
    lo = min(min(ev.t for ev in events), t0) - t0
    hi = max(ev.t + ev.dur for ev in events) - t0
    span = max(hi - lo, 1e-9)
    scale = width / span

    master = ["."] * width
    workers: dict[int, list] = {}
    for ev in events:
        a, b = ev.t - t0, ev.t - t0 + ev.dur
        if ev.kind == telemetry.ROUND:
            _paint(master, lo, scale, a, b,
                   "=" if ev.label == "fused" else "!")
        elif ev.kind == telemetry.TASK:
            row = workers.setdefault(ev.worker, ["."] * width)
            _paint(row, lo, scale, a, b,
                   "#" if ev.label == "done" else "x")

    lines = [f"timeline  [{lo:.3f}s .. {hi:.3f}s from run start]  "
             f"('=' fused round  '!' purged  '#' task done  'x' purged)",
             f"{'master':>9} |{''.join(master)}|"]
    for w in sorted(workers):
        lines.append(f"{f'worker {w}':>9} |{''.join(workers[w])}|")
    return "\n".join(lines)
