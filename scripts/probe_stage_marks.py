"""What the decode graph's stage marks read and cost, on one Hopper GPU.

    python3 scripts/probe_stage_marks.py [--cells yi-6b.chat,...] [--reps 32]

Run from the repository root on a machine with a card.  For each serve
cell of ``BENCHMARK.json`` named, it builds the cell's server at full size
(the benchmark's weights from ``--seed``) and captures its decode step,
plain and with the stage marks (``launch.graphs.record``).  It prints one
JSON line a cell:

- ``sum``: for ``--reps`` replays of the marked graph, the sum of the
  stages read from its marks against a CUDA-event pair around the same
  replay (the ratio's median and extremes) and the median stages in ms;
- ``cost``: the replay's CUDA-event ms of the marked graph and the plain
  one, replays at the same positions in the order marked, plain, plain,
  marked, and the marks' share of the plain replay (what a traced decode
  pays; an untraced one replays the plain graph);
- ``tracing_on``: the host microseconds of one stage read (the wait on
  the last mark excluded) and of one span entered with the profiler on
  and off.

The last line is ``{"ok": true}`` when every sum held within 3 %.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from perfbench import manifest as mf  # noqa: E402
from perfbench.model import make_params, port_config  # noqa: E402


def _timed(dg, graph, tok, positions) -> list[float]:
    """CUDA-event ms of one replay of ``graph`` (one of the decode graph
    ``dg``'s) at each position, back to back."""
    pairs = []
    for p in positions:
        dg.start(tok, p)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def probe(name: str, seed: int, reps: int) -> dict:
    from repro_torch.launch import graphs
    from repro_torch.launch.serve import ProgressiveServer
    c = mf.cell(mf.load(), name)
    t = c["traffic"]
    cfg = port_config(c["config"]["model"])
    params = make_params(cfg, c["config"]["init"], seed, "cuda")
    B, S, G = t["batch"], t["prompt"], t["gen"]
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(seed))
    out = {"cell": name}
    head = c["config"]["head"]
    server = ProgressiveServer(cfg, params, m=head["m"], d=head["d"],
                               device="cuda")
    logits, caches = server.prefill(prompt, S + G)
    tok = torch.argmax(logits, dim=-1)[:, None]
    server.decode(tok, caches, S, 2, layer_budget=t["layer_budget"])
    del logits, caches
    (dg,) = server._graphs.values()
    marks = dg.rec.marks
    out["marks"] = len(marks)
    graph = {"marked": dg.rec.marked, "plain": dg.rec.graph}
    positions = [S + i % G for i in range(reps)]

    # the stages of each replay against a pair around it
    ratios, per_stage = [], {}
    for p in positions:
        whole = _timed(dg, graph["marked"], tok, [p])[0]
        st = graphs.stages(marks)
        ratios.append(1e3 * sum(st.values()) / whole)
        for n, v in st.items():
            per_stage.setdefault(n, []).append(1e3 * v)
    out["sum"] = {"ratio_median": statistics.median(ratios),
                  "ratio_min": min(ratios), "ratio_max": max(ratios),
                  "stages_ms": {n: statistics.median(v)
                                for n, v in per_stage.items()}}

    # the marks' cost: marked, plain, plain, marked at the same positions
    ms = {"marked": [], "plain": []}
    for k in ("marked", "plain", "plain", "marked"):
        ms[k] += _timed(dg, graph[k], tok, positions)
    med = {k: statistics.median(v) for k, v in ms.items()}
    q = {k: statistics.quantiles(v, n=4) for k, v in ms.items()}
    out["cost"] = {"marked_ms": med["marked"], "plain_ms": med["plain"],
                   "iqr_marked_ms": q["marked"][2] - q["marked"][0],
                   "iqr_plain_ms": q["plain"][2] - q["plain"][0],
                   "share_pct": 100 * (med["marked"] / med["plain"] - 1),
                   "replays": len(ms["marked"])}

    # the cost with tracing on: a stage read, and a span
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        graphs.stages(marks)
    read_us = (time.perf_counter() - t0) / 20 * 1e6

    def span_us(n=2000):
        t0 = time.perf_counter()
        for _ in range(n):
            with graphs.span("repro.probe"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = span_us()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = span_us()
    out["tracing_on"] = {"stage_read_us": read_us, "span_on_us": on,
                         "span_off_us": off}
    server.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="yi-6b.chat,mamba2-370m.first-res")
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=2718281828)
    args = ap.parse_args()
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    print(json.dumps({"card": power, "torch": torch.__version__}),
          flush=True)
    ok = True
    for name in args.cells.split(","):
        res = probe(name, args.seed, args.reps)
        ok &= (abs(res["sum"]["ratio_min"] - 1) <= 0.03
               and abs(res["sum"]["ratio_max"] - 1) <= 0.03)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
