"""The paper's §IV evaluation end to end (Figs 2a/2b/3a/3b).

The twin of the JAX package's ``examples/hetero_cluster_sim.py``, with
its own copy of the four figure functions of the reference's
``benchmarks/paper_figures.py`` on the port's ``core.simulator`` (the §IV
event simulator) and its theory bounds (``core.queueing``).  Paper
parameters: P = 5 workers with mu = [385.95, 650.92, 373.40, 415.75,
373.98], Poisson arrivals lambda = 0.01, k = 1000 tasks a matmul, task
complexity 50 (12.5 layered, m = 2, so L = 3 resolution layers).  Each
figure writes a CSV to the output directory and prints its claim-checks;
nothing runs on a card.

    python -m repro_torch.examples.hetero_cluster_sim [--fast] [--out DIR]

``--fast`` cuts Fig 2a to 800 jobs a point (about 10 s on a CPU), as the
reference's flag does; CSVs go to ``results/`` unless ``--out`` names
another directory.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from repro_torch.core import simulator

__all__ = ["fig2a_delay_vs_redundancy", "fig2b_job_realizations",
           "fig3a_delay_distribution", "fig3b_success_rate", "run_all",
           "main"]

RESULTS = "results"


def _write_csv(out_dir: str, name: str, header, rows) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def fig2a_delay_vs_redundancy(num_jobs: int = 4000, seed: int = 0,
                              out_dir: str = RESULTS) -> dict:
    """Average delay vs redundancy ratio + theory lower bounds (Fig 2a)."""
    omegas = [1.0, 1.006, 1.012, 1.018, 1.03, 1.06, 1.1, 1.15, 1.2]
    rows = []
    checks = []
    for om in omegas:
        cfg = simulator.SystemConfig(omega=om)
        lay = simulator.simulate(cfg, num_jobs, layered=True, seed=seed)
        unlay = simulator.simulate(cfg, num_jobs, layered=False, seed=seed)
        d = lay.mean_delay()
        dn = unlay.mean_delay()[0]
        bounds = simulator.theory_bounds(cfg, lay.service_moments(),
                                         layered=True)
        rows.append([om, *d, dn, *bounds])
        checks.append((om, d, bounds, dn))
    path = _write_csv(out_dir, "fig2a_delay_vs_redundancy.csv",
                      ["omega", "D_l0", "D_l1", "D_l2", "D_nolayer",
                       "bound_l0", "bound_l1", "bound_l2"], rows)

    # paper claims: (i) layer delays ordered; (ii) final ~= no-layering;
    # (iii) bounds tight at ~6% redundancy.
    om6 = next(c for c in checks if abs(c[0] - 1.06) < 1e-9)
    tightness = float(np.max((om6[1] - om6[2]) / om6[2]))
    ordered = bool(np.all(np.diff(om6[1]) > 0))
    final_vs_nolayer = abs(om6[1][-1] - om6[3]) / om6[3]
    print(f"fig2a: {path}")
    print(f"  claim[layer order D(0)<D(1)<D(2)]: {ordered}")
    print(f"  claim[final==no-layering within 5%]: "
          f"{final_vs_nolayer:.3f} ({final_vs_nolayer < 0.05})")
    print(f"  claim[bounds tight at omega=1.06]: max gap "
          f"{tightness*100:.1f}% ({tightness < 0.08})")
    return {"tight_at_1.06": tightness, "ordered": ordered,
            "final_vs_nolayer": final_vs_nolayer}


def fig2b_job_realizations(num_jobs: int = 100, seed: int = 1,
                           out_dir: str = RESULTS) -> dict:
    """Per-job delay realizations for the first 100 jobs (Fig 2b)."""
    cfg = simulator.SystemConfig(omega=1.06)
    lay = simulator.simulate(cfg, num_jobs, layered=True, seed=seed)
    unlay = simulator.simulate(cfg, num_jobs, layered=False, seed=seed)
    d = lay.delay
    rows = [[j, *d[j], unlay.delay[j, 0]] for j in range(num_jobs)]
    path = _write_csv(out_dir, "fig2b_realizations.csv",
                      ["job", "D_l0", "D_l1", "D_l2", "D_nolayer"], rows)
    frac_ordered = float(np.mean((d[:, 0] < d[:, 1]) & (d[:, 1] < d[:, 2])))
    print(f"fig2b: {path}")
    print(f"  claim[every job sees layered early results]: "
          f"{frac_ordered*100:.0f}% of jobs strictly ordered")
    return {"frac_ordered": frac_ordered}


def fig3a_delay_distribution(num_jobs: int = 1000, seed: int = 2,
                             out_dir: str = RESULTS) -> dict:
    """Empirical delay distributions per resolution, omega=1.018 (Fig 3a)."""
    cfg = simulator.SystemConfig(omega=1.018)
    lay = simulator.simulate(cfg, num_jobs, layered=True, seed=seed)
    d = lay.delay
    qs = [5, 25, 50, 75, 95]
    rows = []
    for l in range(d.shape[1]):
        pct = np.percentile(d[:, l], qs)
        rows.append([l, d[:, l].mean(), d[:, l].std(), *pct])
    path = _write_csv(out_dir, "fig3a_delay_distribution.csv",
                      ["layer", "mean", "std", "p5", "p25", "p50", "p75",
                       "p95"], rows)
    # higher layers have wider distributions (claim)
    stds = [r[2] for r in rows]
    widening = all(a <= b * 1.05 for a, b in zip(stds, stds[1:]))
    print(f"fig3a: {path}")
    print(f"  claim[higher layers have wider distributions]: {widening} "
          f"(stds: {[f'{s:.2f}' for s in stds]})")
    return {"stds": stds, "widening": widening}


def fig3b_success_rate(num_jobs: int = 1000, seed: int = 3,
                       out_dir: str = RESULTS) -> dict:
    """Success rate vs deadline, omega=1.018 (Fig 3b)."""
    cfg = simulator.SystemConfig(omega=1.018)
    deadlines = [5.0, 7.5, 10.0, 12.5, 15.0, 20.0, 25.0, 30.0, 40.0]
    rows = []
    at10 = None
    for dl in deadlines:
        lay = simulator.simulate(cfg, num_jobs, layered=True, deadline=dl,
                                 seed=seed)
        unlay = simulator.simulate(cfg, num_jobs, layered=False, deadline=dl,
                                   seed=seed)
        sr = lay.success_rate()
        srn = unlay.success_rate()[0]
        rows.append([dl, *sr, srn])
        if dl == 10.0:
            at10 = (sr, srn)
    path = _write_csv(out_dir, "fig3b_success_rate.csv",
                      ["deadline", "sr_l0", "sr_l1", "sr_l2", "sr_nolayer"],
                      rows)
    print(f"fig3b: {path}")
    print(f"  claim[success(l0)=1 at deadline 10 while others lower]: "
          f"l0={at10[0][0]:.3f}, l2={at10[0][2]:.3f}, "
          f"no-layer={at10[1]:.3f}")
    return {"sr_at_10": (float(at10[0][0]), float(at10[0][2]),
                         float(at10[1]))}


def run_all(fast: bool = False, out_dir: str = RESULTS) -> dict:
    """The four figures; ``fast`` cuts Fig 2a to 800 jobs a point."""
    n = 800 if fast else 4000
    return {"fig2a": fig2a_delay_vs_redundancy(num_jobs=n, out_dir=out_dir),
            "fig2b": fig2b_job_realizations(out_dir=out_dir),
            "fig3a": fig3a_delay_distribution(num_jobs=min(n, 1000),
                                              out_dir=out_dir),
            "fig3b": fig3b_success_rate(num_jobs=min(n, 1000),
                                        out_dir=out_dir)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The paper's §IV evaluation (Figs 2a/2b/3a/3b) on the "
                    "event simulator; CSVs and claim-checks.")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default=RESULTS,
                    help=f"directory for the CSVs (default {RESULTS}/)")
    args = ap.parse_args(argv)
    out = run_all(fast=args.fast, out_dir=args.out)

    print("\nsummary of paper-claim checks:")
    print(f"  Fig2a bound tightness @ omega=1.06: "
          f"{out['fig2a']['tight_at_1.06'] * 100:.1f}% gap (paper: ~tight)")
    print(f"  Fig2b strictly-ordered realizations: "
          f"{out['fig2b']['frac_ordered'] * 100:.0f}%")
    print(f"  Fig3b success@deadline=10: l0/l2/no-layer = "
          f"{out['fig3b']['sr_at_10']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
