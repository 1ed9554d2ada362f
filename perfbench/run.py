"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload yi-6b.chat --seed 7 --seconds 40 \\
        --trace 0

from the root of a checkout, on a machine with the card(s) the cell asks
for.  It sets the cell up (the weights from ``--seed`` on the card, the
program's caches, a warm-up of the cell's shapes), runs the cell's traffic
for ``--seconds`` of whole batches or steps, reads the cell's end-to-end
metrics (``--trace 0``) or, after the same window and a profiled stretch,
its per-layer metrics (``--trace 1``), checks what the timed path produced
against the plain reference in ``perfbench/reference/``, and prints one
JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``breakdown`` when traced), and last
``checks``, each number compared with its limit, which also end standard
error.  It exits non-zero and prints no result when there is no card, too
few cards, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def bootstrap() -> None:
    """Put the checkout's root, not this folder, first on the path and the
    port (``src``) after it, and keep every cache a run writes at a fixed
    place in the checkout (the port's own nvcc builds go to
    ``src/repro_torch/kernels/_build``)."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    cache = ROOT / "perfbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


#: top-level module names that must not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def log(what: str, t_start: float = T_START) -> None:
    """A progress line on standard error: seconds since ``t_start``."""
    print(f"perfbench: {time.perf_counter() - t_start:8.2f} s {what}",
          file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def context(c: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """What a driver reads: the cell's files, the port's config, the
    weights drawn from ``seed`` on ``device``, and the run's settings."""
    from perfbench.model import make_params, port_config
    import repro_torch.models.transformer  # noqa: F401
    log("the port imported", t_start)
    cfg = port_config(c["config"]["model"])
    params = make_params(cfg, c["config"]["init"], seed, device)
    log("weights drawn", t_start)
    return {"cell": c["workload"]["name"], "model": c["config"]["model"],
            "head": c["config"]["head"], "traffic": c["traffic"],
            "reference": c["reference"], "cfg": cfg, "seed": seed,
            "seconds": seconds, "trace": trace, "device": device,
            "t_start": t_start, "tmpdir": tempfile.gettempdir(),
            "log": lambda what: log(what, t_start),
            "params": params}


def driver(kind: str):
    """The module that runs and checks a traffic mix of ``kind``."""
    import importlib
    return importlib.import_module(
        {"serve": "perfbench.serving", "train": "perfbench.training"}[kind])


def measure(manifest: dict, c: dict, ctx: dict) -> tuple[dict, dict]:
    """Run the cell; returns (its record, its metrics)."""
    from perfbench import manifest as mf
    rec = driver(c["traffic"]["kind"]).run(ctx)
    metrics = {}
    for m in mf.metrics_for(manifest, ctx["cell"], ctx["trace"]):
        value = mf.reader(m["name"])(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return rec, metrics


def judge(rec: dict, ctx: dict, limits: dict) -> tuple[bool, dict]:
    """Compare what the timed path produced with the reference; returns
    (correct, {number: {"value", "limit"}}) for each number the cell's
    limits name."""
    import torch
    if torch.device(ctx["device"]).type == "cuda":
        torch.cuda.empty_cache()
    readings = driver(ctx["traffic"]["kind"]).check(rec, ctx)
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in limits.items()}
    return all(x["value"] <= x["limit"] for x in checks.values()), checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import manifest as mf
    manifest = mf.load()
    c = mf.cell(manifest, args.workload)
    import torch
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.init()
    log("torch imported, card ready")
    ctx = context(c, args.seed, args.seconds, bool(args.trace), device,
                  T_START)
    rec, metrics = measure(manifest, c, ctx)
    log("metrics read")
    correct, checks = judge(rec, ctx, c["limits"])
    log("reference compared")
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"],
           "power": _power_limit()}
    result = {"correct": correct, "attempted": rec["requests"],
              "failed": 0, "metrics": metrics, "device": dev}
    if args.trace:
        tr = rec["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    if rec.get("batches"):
        print("perfbench: batches (prefill ms, decode ms): " + " ".join(
            f"{b['prefill_s'] * 1e3:.1f}/{b['decode_s'] * 1e3:.1f}"
            for b in rec["batches"]), file=sys.stderr)
    for name, x in checks.items():
        print(f"check {name} {x['value']!r} limit {x['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    bootstrap()
    raise SystemExit(main())
