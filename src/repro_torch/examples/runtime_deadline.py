"""The measured runtime under stragglers and deadlines, end to end.

1. A worker pool with one *stalled* worker and a deadline the final
   resolution misses: every job still releases a decode-verified lower
   resolution: the paper's headline, on a real execution instead of a
   sampled one.
2. The same cluster without deadlines, cross-checked against the §IV
   event simulator: measured per-resolution mean delays track the
   simulated ones and keep the MSB-first ordering res0 < ... < final.

The twin of the JAX package's ``examples/runtime_deadline.py``.  Its
workers compute on the card (``backend="cuda"``), or on host threads
with ``--device cpu``.

    python -m repro_torch.examples.runtime_deadline              # card
    python -m repro_torch.examples.runtime_deadline --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import simulator
from repro_torch.runtime import (RuntimeConfig, delay_table,
                                 format_delay_table, run_jobs)


def part1_stall_and_deadline(backend: str) -> None:
    print("=" * 72)
    print("1) Stalled worker + deadline: partial resolutions still ship")
    # worker 2 holds 1 of the 6 coded tasks (eq.(1) split [2, 3, 1]); the
    # omega = 1.5 redundancy is exactly what lets rounds fuse without it.
    cfg = RuntimeConfig(mu=(400.0, 650.0, 380.0), arrival_rate=14.0,
                        complexity=8.0, deadline=0.030, straggler="stall",
                        stall_workers=(2,), stall_seconds=2.0, seed=0,
                        backend=backend)
    result, _ = run_jobs(cfg, num_jobs=30, K=64, M=8, N=8, verify=True)
    hist = result.release_histogram()
    sr = result.success_rate()
    print(f"   worker 2 stalls on every task; deadline = "
          f"{cfg.deadline * 1e3:.0f} ms from service start")
    print(f"   terminated {int(result.terminated.sum())}/{result.num_jobs} "
          f"jobs; released resolution histogram (none, res0, res1, res2): "
          f"{hist.tolist()}")
    print("   success rate per resolution: "
          + "  ".join(f"l{l}={sr[l]:.2f}" for l in range(len(sr))))
    errs = result.verify_errors[np.isfinite(result.verify_errors)]
    if errs.size:
        print(f"   every released resolution decode-verified vs the exact "
              f"layered oracle: max rel err {errs.max():.2e}")
    term = np.flatnonzero(result.terminated)
    if term.size:
        j = term[0]
        print(f"   e.g. job {j}: final resolution cut off, released "
              f"resolution {result.released[j]} "
              f"(ready {result.layer_compute[j, result.released[j]] * 1e3:.1f}"
              f" ms after service start)")


def part2_runtime_vs_simulator(backend: str) -> None:
    print("=" * 72)
    print("2) Measured runtime vs the §IV simulator (same configuration)")
    cfg = RuntimeConfig(mu=(400.0, 650.0, 380.0), arrival_rate=8.0,
                        complexity=8.0, straggler="exp", seed=1,
                        backend=backend)
    result, _ = run_jobs(cfg, num_jobs=40, K=64, M=8, N=8)
    sim = simulator.simulate(cfg.to_system_config(), 4000, layered=True,
                             seed=1)
    bounds = simulator.theory_bounds(cfg.to_system_config(),
                                     sim.service_moments(), layered=True)
    print(f"   measured (40 jobs, {backend} workers, real matmuls):")
    print(format_delay_table(delay_table(result)))
    print("   simulated (4000 jobs) + eq.(4) bounds:")
    print(format_delay_table(delay_table(sim, bounds=bounds)))
    md, sd = result.mean_delay(), sim.mean_delay()
    assert np.all(np.diff(md) > 0), "measured delays must be MSB-ordered"
    print(f"   first-resolution mean delay: measured {md[0] * 1e3:.1f} ms "
          f"vs simulated {sd[0] * 1e3:.1f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the workers compute: cuda (default) or cpu")
    args = ap.parse_args(argv)
    backend = "cuda" if resolve_device(args.device).type == "cuda" \
        else "thread"
    part1_stall_and_deadline(backend)
    part2_runtime_vs_simulator(backend)
    print("=" * 72)
    print("runtime_deadline OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
