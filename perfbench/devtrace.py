"""The device trace of a traced stretch, reduced to what the per-layer
metrics read.

``traced(fn, tmpdir)`` runs ``fn`` under ``torch.profiler`` (host and
device activities) inside a ``bench.window`` range, writes the Chrome
trace to ``tmpdir``, reads it back and deletes it.  The harness marks the
calls it makes into the program with ``record_function`` ranges named
``bench.<what>`` (:func:`span`).  :func:`summarize` gives, for each range,
its host interval, the device time of the work launched inside it (each
kernel, copy and fill matched to its launch by the profiler's correlation
id, so a graph replay's kernels count for the range that replayed it) and
the device's busy time inside its interval; for the window, the busy and
idle seconds, the operations that took the most device time, and the
longest idle gaps named by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import pathlib
from collections import defaultdict

__all__ = ["span", "traced", "summarize", "WINDOW"]

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range named ``bench.<name>``."""
    from torch.profiler import record_function
    with record_function("bench." + name):
        yield


def traced(fn, tmpdir) -> dict:
    """Run ``fn()`` under the profiler and return :func:`summarize` of its
    trace; ``fn`` must end in a device synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    path = pathlib.Path(tmpdir) / f"bench-trace-{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return summarize(events)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy(union: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


def summarize(events: list) -> dict:
    """Reduce Chrome-trace ``events`` (times in microseconds) to the
    ``ranges``, ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps``
    of the module docstring.  Raises if the trace has no window or no
    device activity."""
    xs = [e for e in events if e.get("ph") == "X"]
    device = [e for e in xs if e.get("cat") in _DEVICE_CATS]
    windows = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no bench.window range")
    if not device:
        raise RuntimeError("the trace holds no device operation")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    union = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in device])
    by_corr = defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += float(e["dur"])
    launches = sorted((float(e["ts"]), e.get("tid"),
                       e.get("args", {}).get("correlation"))
                      for e in xs if e.get("cat") in _LAUNCH_CATS)
    starts = [t for t, _, _ in launches]
    ranges = defaultdict(list)
    for e in xs:
        name = e.get("name", "")
        if (e.get("cat") != "user_annotation" or not name.startswith("bench.")
                or name == WINDOW):
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        i, j = bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1)
        dev_us = sum(by_corr.get(c, 0.0) for _, tid, c in launches[i:j]
                     if tid == e.get("tid") and c is not None)
        ranges[name[len("bench."):]].append(
            {"t0_us": t0, "t1_us": t1, "wall_s": (t1 - t0) / 1e6,
             "device_s": dev_us / 1e6, "busy_s": _busy(union, t0, t1) / 1e6})
    for rs in ranges.values():
        rs.sort(key=lambda r: r["t0_us"])
    busy = _busy(union, w0, w1)
    ops = defaultdict(float)
    for e in device:
        ops[e.get("name", "?")[:100]] += float(e["dur"]) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"ranges": dict(ranges), "busy_s": busy / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": _idle_gaps(union, w0, w1, xs)}


def _idle_gaps(union: list, w0: float, w1: float, xs: list) -> list:
    """The ten longest stretches of the window with nothing on the device,
    each named by the innermost host event that covers its middle."""
    gaps, t = [], w0
    for a, b in union:
        if b <= w0 or a >= w1:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in xs if e.get("cat") in _HOST_CATS
            and e.get("name") != WINDOW]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        covering = [e for e in host
                    if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = (min(covering, key=lambda e: float(e["dur"]))["name"][:100]
                if covering else "host idle")
        out.append([name, (b - a) / 1e6])
    return out
