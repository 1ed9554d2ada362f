"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Run from the repository root (the port lives in ``src/repro_torch``).  It
builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), then drives the port's
two main paths and checks what comes out:

1. environment: card name and power limit, torch/CUDA versions, build time;
2. the layered int8 matmul kernel against its plain PyTorch version on the
   card, bit-exactly, at the llama3-8b LM-head contraction (K=4096, M=64,
   N=128256), a square 4096^3 and a ragged m=3 case, with CUDA-event
   medians of the kernel, the plain version and (as a reference point
   only) m^2 int8 ``torch._int_mm`` calls, the kernel's device time from
   ``torch.profiler``, and the kernel's bound;
3. main path 1, ``kernels.ops.layered_matmul`` at the LM-head contraction
   (launch counts reset before it and read after it; then the medians of
   the whole wrapper and of its plane preparation of W), and the fused
   wrapper against the int64 NumPy oracle at a mid size;
4. main path 2, the coded runtime on the ``cuda`` worker backend: a
   verified run, then a full-width K=M=N=4096 run whose released final
   resolutions are held against the exact float64 product on the card;
5. one ``{"kernels": [...]}`` line with every kernel's launches on the
   main path, its largest difference from its plain version, its times
   and its bound.

Each phase prints one JSON line.  The card's name and power limit follow,
and the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
makes the script exit non-zero without that line; with no CUDA device, or
without the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

#: Every CUDA source of the port (src/repro_torch/kernels/csrc/<name>.cu).
KERNEL_SOURCES = ["layered_matmul"]

SEED = 0
HEAD = dict(K=4096, M=64, N=128256, m=2, d=7)      # llama3-8b LM head
SQUARE = dict(K=4096, M=4096, N=4096, m=2, d=7)
RAGGED = dict(K=1000, M=200, N=328, m=3, d=5)
TIMED_RUNS = 20
REPS = 5          # back-to-back launches per timed run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Per-call ms: the median over ``runs`` CUDA-event-timed runs of
    :data:`REPS` back-to-back calls each, after ``warmup`` calls.  A call
    shorter than its host-side launch cost reads as the launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, runs: int = 10):
    """Mean device time (ms) of the CUDA kernels whose name contains
    ``kernel``, over ``runs`` calls under ``torch.profiler`` — the
    kernel alone, without the host's launch cost.  None when the
    profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in rows)
    if not count:
        return None
    return sum(e.device_time_total for e in rows) / count / 1e3


def layered_bound(K: int, M: int, N: int, m: int) -> tuple[float, str]:
    """Least time (ms) for the layered matmul's work on an H100, and what
    sets it: each plane byte read once, each int32 partial written once;
    2 m^2 M N K int8 operations."""
    ops = 2 * m * m * M * N * K
    nbytes = m * K * (M + N) + 4 * (2 * m - 1) * M * N
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_ints(torch, gen, m: int, d: int, shape, dev):
    hi = 1 << (m * d - 1)
    return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def phase_environment(torch, dev):
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    ptxas = [line.strip() for n in KERNEL_SOURCES
             for line in _build.build_log[n]["ptxas"].splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "environment", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(dev),
          "capability": list(torch.cuda.get_device_capability(dev)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_seconds": wall, "ptxas": ptxas})
    return smi


def phase_kernel_vs_plain(torch, dev):
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for name, s in (("llama3_8b_head", HEAD), ("square_4096", SQUARE),
                    ("ragged_m3", RAGGED)):
        K, M, N, m, d = s["K"], s["M"], s["N"], s["m"], s["d"]
        a = random_ints(torch, gen, m, d, (K, M), dev)
        b = random_ints(torch, gen, m, d, (K, N), dev)
        pa = ops._planes_kmajor(a, m, d)
        pb = ops._planes_kmajor(b, m, d)
        got = lm.layered_matmul_kmajor(pa, pb, m=m)
        want = lm.layered_matmul_plain(pa, pb, m=m)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64))
                  .abs().max().item())
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version by {err}")
        del got, want
        ms = cuda_ms(torch, lambda: lm.layered_matmul_kmajor(pa, pb, m=m))
        dev_ms = device_ms(torch,
                           lambda: lm.layered_matmul_kmajor(pa, pb, m=m),
                           "layered_matmul_kernel")
        plain_ms = cuda_ms(torch,
                           lambda: lm.layered_matmul_plain(pa, pb, m=m))
        bt = pb[0].T        # (K, N) column-major: the int8 "TN" layout
        int_mm_ms = cuda_ms(torch, lambda: torch._int_mm(pa[0], bt))
        bound_ms, bound_by = layered_bound(K, M, N, m)
        rows[name] = {"shape": s, "max_abs_err": err, "ms": ms,
                      "kernel_device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "int_mm_x_m2_ms": m * m * int_mm_ms,
                      "bound_share": bound_ms / ms}
        del a, b, pa, pb, bt
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "timed_runs": TIMED_RUNS,
          "calls_per_run": REPS, "shapes": rows})
    return rows


def phase_layered_main_path(torch, dev):
    import numpy as np

    from repro_torch.core import layering
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    K, M, N, m, d = HEAD["K"], HEAD["M"], HEAD["N"], HEAD["m"], HEAD["d"]
    hidden_t = random_ints(torch, gen, m, d, (K, M), dev)   # hidden.T
    w = random_ints(torch, gen, m, d, (K, N), dev)
    torch.cuda.synchronize()
    lm.launches = 0
    t0 = time.perf_counter()
    res = ops.layered_matmul(hidden_t, w, m=m, d=d)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = lm.launches
    if launches < 1:
        raise AssertionError("main path never launched the kernel")
    exact = hidden_t.to(torch.float64).T @ w.to(torch.float64)
    if res.shape != (2 * m - 1, M, N) or not torch.isfinite(res).all():
        raise AssertionError(f"bad output {tuple(res.shape)}")
    head_rel = ((res[-1].to(torch.float64) - exact).abs().max()
                / exact.abs().max()).item()
    if head_rel > 1e-6:
        raise AssertionError(f"final resolution off by {head_rel} relative")
    # after the counted run: the whole wrapper, and its plane preparation
    # of W alone, as medians
    wrapper_ms = cuda_ms(torch, lambda: ops.layered_matmul(hidden_t, w, m=m,
                                                           d=d), runs=5)
    planes_w_ms = cuda_ms(torch, lambda: ops._planes_kmajor(w, m, d), runs=5)
    # the fused wrapper against the int64 oracle at a mid size
    Km, Mm, Nm = 1024, 256, 256
    rng = np.random.default_rng(SEED)
    hi = 1 << (m * d - 1)
    A = rng.integers(-hi, hi, size=(Km, Mm))
    B = rng.integers(-hi, hi, size=(Km, Nm))
    got = ops.layered_matmul(torch.from_numpy(A).to(dev),
                             torch.from_numpy(B).to(dev), m=m, d=d)
    want = layering.layered_matmul_reference(A, B, m=m, d=d)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6)
    emit({"phase": "layered_matmul_main_path", "shape": HEAD,
          "launches": {"layered_matmul": launches},
          "wall_ms_incl_decompose": wall_ms, "wrapper_ms": wrapper_ms,
          "planes_w_ms": planes_w_ms,
          "final_rel_err_vs_exact": head_rel,
          "mid_size_vs_oracle": {"K": Km, "M": Mm, "N": Nm, "rtol": 1e-6,
                                 "ok": True}})
    return launches


def phase_runtime(torch, dev):
    import numpy as np

    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.runtime import (RuntimeConfig, delay_table, make_jobs,
                                     run_jobs)
    from repro_torch.runtime.master import Master
    lm.launches = 0
    cfg = RuntimeConfig(backend="cuda", straggler="exp", seed=SEED)
    t0 = time.perf_counter()
    res, _ = run_jobs(cfg, num_jobs=4, K=1024, M=512, N=512, verify=True)
    verified_s = time.perf_counter() - t0
    errs = res.verify_errors[np.isfinite(res.verify_errors)]
    if res.backend != "cuda" or res.tasks_done <= 0:
        raise AssertionError(f"backend={res.backend} "
                             f"tasks_done={res.tasks_done}")
    if errs.size == 0 or errs.max() > 1e-9:
        raise AssertionError(f"verify errors {res.verify_errors}")

    # full width: K = M = N = 4096, five default workers, no host oracle
    fcfg = RuntimeConfig(backend="cuda", m=2, d=8, n1=2, n2=2, omega=1.5,
                         seed=SEED)
    jobs = make_jobs(fcfg, 3, K=4096, M=4096, N=4096)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fres, futures = Master(fcfg, verify=False).run(jobs)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
    # device time summed over every kernel and copy the run issued (on
    # all worker streams, so overlap between streams counts twice)
    device_rows = sorted(((e.key, e.count, e.device_time_total / 1e3)
                          for e in prof.key_averages()
                          if e.device_time_total > 0),
                         key=lambda r: -r[2])
    device_ms = sum(r[2] for r in device_rows)
    if fres.backend != "cuda" or fres.tasks_done <= 0:
        raise AssertionError(f"backend={fres.backend}")
    final_errs = []
    for job, lr in zip(jobs, futures):
        if lr.released_resolution != fcfg.num_layers - 1:
            raise AssertionError(f"job {job.job_id} released "
                                 f"{lr.released_resolution}")
        a = torch.from_numpy(job.a).to(dev, torch.float64)
        b = torch.from_numpy(job.b).to(dev, torch.float64)
        exact = a.T @ b        # exact: 4096 * 2^28 < 2^53
        got = torch.from_numpy(np.asarray(lr.result())).to(dev)
        rel = ((got - exact).abs().max() / exact.abs().max()).item()
        final_errs.append(rel)
        if rel > 1e-9:
            raise AssertionError(f"job {job.job_id} final resolution off by "
                                 f"{rel} relative")
    emit({"phase": "runtime_cuda_backend",
          "verified": {"jobs": 4, "K": 1024, "M": 512, "N": 512,
                       "backend": res.backend, "tasks_done": res.tasks_done,
                       "max_verify_error": float(errs.max()),
                       "wall_seconds": verified_s},
          "full_width": {"jobs": len(jobs), "K": 4096, "M": 4096, "N": 4096,
                         "m": 2, "d": 8, "n1": 2, "n2": 2, "omega": 1.5,
                         "workers": fcfg.num_workers,
                         "tasks_done": fres.tasks_done,
                         "final_rel_err_vs_exact": final_errs,
                         "stage_seconds": fres.stage_seconds,
                         "stage_rounds": fres.stage_rounds,
                         "wall_seconds": full_s,
                         "device_ms_summed": device_ms,
                         "device_busy_share": device_ms / (full_s * 1e3),
                         "device_top": device_rows[:4],
                         "mean_delay_by_resolution": [
                             row["mean_delay"] for row in delay_table(fres)]},
          "launches": {"layered_matmul": lm.launches}})


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    failed = []
    results = {}
    for name, phase in (("environment", phase_environment),
                        ("kernel_vs_plain", phase_kernel_vs_plain),
                        ("layered_main_path", phase_layered_main_path),
                        ("runtime", phase_runtime)):
        try:
            results[name] = phase(torch, dev)
        except Exception:      # reported, and the run fails below
            traceback.print_exc()
            emit({"phase": name, "ok": False})
            failed.append(name)
    if "kernel_vs_plain" in results and "layered_main_path" in results:
        head = results["kernel_vs_plain"]["llama3_8b_head"]
        errs = [row["max_abs_err"]
                for row in results["kernel_vs_plain"].values()]
        emit({"kernels": [{
            "name": "layered_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/layered_matmul.cu",
            "replaces": "src/repro/kernels/layered_matmul.py:71",
            "launches": results["layered_main_path"],
            "max_abs_err": max(errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None}]})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(results["environment"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
