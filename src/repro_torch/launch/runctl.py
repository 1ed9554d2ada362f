"""``runctl`` — drive the measured runtime engine from the command line.

Runs a coded layered-matmul workload on the real master/worker/fusion
runtime (``repro_torch.runtime``), prints the paper-style per-resolution
delay table, and optionally validates the measurement against the §IV
event simulator and the eq. (4) theory bounds on the same configuration.
Workers run on the card by default (``--backend cuda``); ``--backend
thread``, ``process`` or ``socket`` run them on host BLAS.

Examples::

    # 200 jobs, exp stragglers, 35 ms deadline, verify decodes, JSON out
    PYTHONPATH=src python -m repro_torch.launch.runctl --jobs 200 \
        --complexity 10 --deadline 0.035 --straggler exp \
        --json results/runctl.json

    # same cluster on host threads, cross-checked against the simulator
    PYTHONPATH=src python -m repro_torch.launch.runctl --jobs 100 \
        --backend thread --compare-sim

    # multi-host: start a worker host per machine, then drive them
    PYTHONPATH=src python -m repro_torch.launch.runctl serve-worker --port 7001
    PYTHONPATH=src python -m repro_torch.launch.runctl --jobs 100 \
        --backend socket --hosts hostA:7001,hostB:7001,hostC:7001 \
        --mu 400,650,380

    # traced run: Perfetto-loadable timeline of the whole pipeline,
    # remote worker spans clock-aligned onto the master timebase
    PYTHONPATH=src python -m repro_torch.launch.runctl --jobs 20 \
        --backend socket --local-cluster --trace out.json --timeline

    # serving gateway: open request stream with per-request deadlines
    # and G/G/1 admission over one shared fleet
    PYTHONPATH=src python -m repro_torch.launch.runctl serve-gateway \
        --requests 60 --rate 20 --deadline 0.06 --json gateway.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from repro_torch.core import simulator
from repro_torch.runtime import (BACKEND_NAMES, CODE_FAMILIES, FAULT_POLICIES,
                           FRAME_PROTOS, POLICIES, SHM_MODES,
                           RuntimeConfig, delay_table,
                           format_controller_trace, format_delay_table,
                           format_stage_table, run_jobs)

__all__ = ["main", "build_config", "summarize"]


def _floats(text: str) -> tuple[float, ...]:
    return tuple(float(x) for x in text.split(",") if x)


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split(",") if x)


def _wants_trace(args: argparse.Namespace) -> bool:
    """Any trace-output flag turns structured tracing on for the run."""
    return bool(getattr(args, "trace", None)
                or getattr(args, "trace_jsonl", None)
                or getattr(args, "timeline", False)
                or getattr(args, "metrics_out", None))


def build_config(args: argparse.Namespace,
                 hosts: tuple[str, ...] | None = None) -> RuntimeConfig:
    return RuntimeConfig(
        mu=_floats(args.mu), arrival_rate=args.arrival_rate,
        n1=args.n1, n2=args.n2, omega=args.omega, m=args.planes, d=args.d,
        gamma=args.gamma, complexity=args.complexity,
        deadline=args.deadline, straggler=args.straggler,
        stall_workers=_ints(args.stall_workers),
        stall_seconds=args.stall_seconds,
        shift_at=args.shift_at if args.shift_at is not None else 0.0,
        burst_period=args.burst_period, burst_len=args.burst_len,
        adapt=args.adapt, omega_min=args.omega_min,
        omega_max=args.omega_max, backend=args.backend,
        hosts=(hosts if hosts is not None
               else tuple(h for h in args.hosts.split(",") if h)),
        compress=args.compress, shm=args.shm,
        frame_proto=args.frame_proto,
        code_family=args.code_family, levels=args.levels,
        trace=_wants_trace(args), seed=args.seed,
        fault_policy=args.fault_policy,
        heartbeat_interval=args.heartbeat_interval,
        heartbeat_timeout=args.heartbeat_timeout,
        reconnect_attempts=args.reconnect_attempts,
        reconnect_backoff=args.reconnect_backoff,
        reconnect_backoff_cap=args.reconnect_backoff_cap)


def summarize(cfg: RuntimeConfig, result) -> dict:
    """JSON-serializable run summary (the ``--json`` artifact)."""
    rows = delay_table(result)
    out = {
        "config": {
            "mu": list(cfg.mu), "arrival_rate": cfg.arrival_rate,
            "n1": cfg.n1, "n2": cfg.n2, "omega": cfg.omega, "m": cfg.m,
            "d": cfg.d, "gamma": cfg.gamma, "complexity": cfg.complexity,
            "deadline": cfg.deadline, "straggler": cfg.straggler,
            "stall_workers": list(cfg.stall_workers), "seed": cfg.seed,
            "backend": cfg.backend, "code_family": cfg.code_family,
            "levels": cfg.levels,
        },
        "backend": result.backend,
        "num_jobs": int(result.num_jobs),
        "kappa": [int(x) for x in result.kappa],
        "delay_per_resolution": rows,
        "terminated_jobs": int(result.terminated.sum()),
        "release_histogram": [int(x) for x in result.release_histogram()],
        "worker_utilization": [round(float(u), 4)
                               for u in result.utilization],
        "stale_results": int(result.stale_results),
        "tasks_done": int(result.tasks_done),
        "tasks_purged": int(result.tasks_purged),
        "fault_policy": result.fault_policy,
        "workers_lost": int(result.workers_lost),
        "degraded_jobs": (int(result.degraded.sum())
                          if result.degraded is not None else 0),
        "fault_log": result.fault_log or [],
        "clock_sync": result.clock_sync,
        "wall_elapsed": float(result.wall_elapsed),
        "stage_seconds": {k: float(v)
                          for k, v in (result.stage_seconds or {}).items()},
        "stage_rounds": int(result.stage_rounds),
        "controller": result.controller,
        "omega_trace": result.omega_trace,
        "transport_stats": result.transport_stats,
    }
    if result.verify_errors is not None:
        finite = result.verify_errors[np.isfinite(result.verify_errors)]
        out["max_verify_rel_error"] = (float(finite.max())
                                       if finite.size else None)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve-worker":
        # the remote half of the socket backend: run one worker host
        # (kept out of the flag namespace below — it is a different
        # program sharing the runctl entrypoint)
        from repro_torch.launch import worker_host
        return worker_host.main(argv[1:])
    if argv and argv[0] == "serve-gateway":
        # the serving front-end: open request stream, per-request
        # deadlines, G/G/1 admission — see repro_torch.launch.serve_gateway
        from repro_torch.launch import serve_gateway
        return serve_gateway.main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="runctl", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=50)
    ap.add_argument("--mu", default="385.95,650.92,373.40,415.75,373.98",
                    help="comma list of worker service rates")
    ap.add_argument("--arrival-rate", type=float, default=12.0,
                    help="Poisson job arrivals per second")
    ap.add_argument("--n1", type=int, default=2)
    ap.add_argument("--n2", type=int, default=2)
    ap.add_argument("--omega", type=float, default=1.5)
    ap.add_argument("--planes", "-m", type=int, default=2, dest="planes",
                    help="digit chunks m (L = 2m-1 resolutions)")
    ap.add_argument("--d", type=int, default=8, help="digit width, bits")
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--complexity", type=float, default=10.0,
                    help="per-task complexity: exp straggler delay scale is "
                         "complexity / (m^2 mu_p) seconds")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds from service start (None = no deadline)")
    ap.add_argument("--straggler",
                    choices=("none", "exp", "stall", "shift", "burst"),
                    default="exp")
    ap.add_argument("--stall-workers", default="",
                    help="comma list of worker ids that go dark "
                         "(stall/shift/burst modes)")
    ap.add_argument("--stall-seconds", type=float, default=30.0)
    ap.add_argument("--shift-at", type=float, default=None,
                    help="shift mode: seconds until stall-workers go dark "
                         "(required with --straggler shift; 0 would just "
                         "be 'stall' with extra steps)")
    ap.add_argument("--burst-period", type=float, default=1.0,
                    help="burst mode: seconds between outage starts")
    ap.add_argument("--burst-len", type=float, default=0.2,
                    help="burst mode: outage seconds per period")
    ap.add_argument("--adapt", choices=tuple(sorted(POLICIES)),
                    default="fixed",
                    help="online omega policy (fixed = the paper's static "
                         "redundancy)")
    ap.add_argument("--omega-min", type=float, default=1.0)
    ap.add_argument("--omega-max", type=float, default=3.0)
    ap.add_argument("--backend", choices=BACKEND_NAMES, default="cuda",
                    help="worker transport: cuda (thread workers whose "
                         "coded products run on the card), thread "
                         "(in-process pool), process (multiprocessing "
                         "workers, GIL-free), or socket (remote worker "
                         "hosts over TCP — see 'runctl serve-worker'); "
                         "all but cuda compute on host BLAS")
    ap.add_argument("--hosts", default="",
                    help="socket backend: comma list of host:port worker "
                         "hosts, one per --mu entry (each running "
                         "'runctl serve-worker')")
    ap.add_argument("--compress", choices=("auto", "none", "zlib", "lz4"),
                    default="auto",
                    help="socket backend frame compression (auto = "
                         "compress big payloads with the best available "
                         "codec)")
    ap.add_argument("--shm", choices=SHM_MODES, default="auto",
                    help="process backend: shared-memory block arenas "
                         "(zero-copy dispatch/results over descriptors; "
                         "auto = on when available, falling back to "
                         "pickled pipes; on = required, raise if arenas "
                         "cannot be created)")
    ap.add_argument("--frame-proto", type=int, choices=FRAME_PROTOS,
                    default=0, dest="frame_proto",
                    help="socket backend frame protocol: 0 = negotiate "
                         "the newest both sides speak (LRF2 when "
                         "possible), 1 = force LRF1 (one pickle per "
                         "frame, mixed-version escape hatch), 2 = "
                         "require LRF2 (pickle-free ndarray frames)")
    ap.add_argument("--code-family", choices=CODE_FAMILIES,
                    default="polynomial", dest="code_family",
                    help="coded-task family: polynomial = one coded round "
                         "per mini-job (the paper's scheme), hierarchical "
                         "= grouped level rounds with per-level MDS rates "
                         "and sub-task-granular dispatch/fusion (straggler "
                         "work on deeper levels is salvaged, not purged)")
    ap.add_argument("--levels", type=int, default=1,
                    help="hierarchical group size: consecutive MSB-first "
                         "rounds dispatched as one group (>= 2 with "
                         "--code-family hierarchical; must stay 1 for "
                         "polynomial)")
    ap.add_argument("--fault-policy", choices=FAULT_POLICIES,
                    default="fail-fast",
                    help="worker-loss handling: fail-fast raises on any "
                         "dead worker; degrade quarantines it, "
                         "re-dispatches its in-flight slice to survivors, "
                         "and releases at a degraded resolution only when "
                         "the fleet falls below k (docs/fault-tolerance.md)")
    ap.add_argument("--heartbeat-interval", type=float, default=1.0,
                    help="socket backend: seconds between liveness pings")
    ap.add_argument("--heartbeat-timeout", type=float, default=15.0,
                    help="socket backend: seconds of silence before a "
                         "worker host is declared dead")
    ap.add_argument("--reconnect-attempts", type=int, default=2,
                    help="socket backend: re-dials before a dropped "
                         "connection is declared dead")
    ap.add_argument("--reconnect-backoff", type=float, default=0.05,
                    help="socket backend: base re-dial backoff in seconds "
                         "(doubles per attempt, jittered)")
    ap.add_argument("--reconnect-backoff-cap", type=float, default=2.0,
                    help="socket backend: ceiling of the exponential "
                         "re-dial backoff, seconds")
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--N", type=int, default=8)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip decode-vs-oracle verification")
    ap.add_argument("--profile", action="store_true",
                    help="print the per-stage master pipeline breakdown "
                         "(prep/encode/dispatch/wait/decode/publish/"
                         "control) and the omega controller trace")
    ap.add_argument("--compare-sim", action="store_true",
                    help="also run the §IV simulator + eq.(4) bounds on the "
                         "same configuration")
    ap.add_argument("--sim-jobs", type=int, default=4000)
    ap.add_argument("--json", default=None, help="write summary JSON here")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a structured trace and write it here as "
                         "Chrome trace-event JSON (load in Perfetto / "
                         "chrome://tracing); remote worker spans are "
                         "clock-aligned onto the master timebase")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="also write the raw trace as one JSON event per "
                         "line (for ad-hoc analysis)")
    ap.add_argument("--timeline", action="store_true",
                    help="print an ASCII Gantt of the traced run (implies "
                         "tracing, like --trace)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump a Prometheus text-format snapshot of the "
                         "run's counters here (implies tracing)")
    ap.add_argument("--local-cluster", action="store_true",
                    help="socket backend: spawn one worker-host process per "
                         "--mu entry on localhost instead of naming "
                         "--hosts (smoke runs and demos)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.straggler == "shift" and args.shift_at is None:
        ap.error("--straggler shift needs an explicit --shift-at (seconds "
                 "until the outage); an implicit 0 would start the run "
                 "already degraded, never showing the regime change")
    if args.straggler in ("shift", "burst") and not _ints(args.stall_workers):
        ap.error(f"--straggler {args.straggler} needs --stall-workers: "
                 f"with none listed, the regime change is a no-op")
    if args.local_cluster and args.backend != "socket":
        ap.error("--local-cluster spawns socket worker hosts; it needs "
                 f"--backend socket, not {args.backend!r}")
    if args.local_cluster and args.hosts:
        ap.error("--local-cluster and --hosts are exclusive: the former "
                 "spawns its own localhost worker hosts")
    if args.backend == "socket" and not (args.hosts or args.local_cluster):
        ap.error("--backend socket needs --hosts host:port,... (one per "
                 "--mu entry; start each with 'runctl serve-worker') or "
                 "--local-cluster")

    cluster = None
    if args.local_cluster:
        from repro_torch.runtime.transport.socket_host import LocalCluster
        cluster = LocalCluster(len(_floats(args.mu)))
    try:
        cfg = build_config(
            args, hosts=cluster.hosts if cluster is not None else None)
        return _run(args, cfg)
    finally:
        if cluster is not None:
            cluster.close()


def _run(args: argparse.Namespace, cfg: RuntimeConfig) -> int:
    print(f"[runctl] {cfg.num_workers} workers ({cfg.backend} backend), "
          f"k={cfg.k} of T={cfg.total_tasks} coded tasks/round, "
          f"{cfg.num_rounds} rounds, L={cfg.num_layers} resolutions, "
          f"straggler={cfg.straggler}, deadline={cfg.deadline}, "
          f"adapt={cfg.adapt}, fault={cfg.fault_policy}")
    result, _ = run_jobs(cfg, args.jobs, K=args.K, M=args.M, N=args.N,
                         verify=not args.no_verify)
    print(f"[runctl] kappa (eq.1 split): {result.kappa.tolist()}  "
          f"utilization: {np.round(result.utilization, 3).tolist()}")
    print(f"[runctl] terminated {int(result.terminated.sum())}/"
          f"{result.num_jobs} jobs; release histogram "
          f"(none, res0..): {result.release_histogram().tolist()}; "
          f"stale results: {result.stale_results}")
    if result.workers_lost or (result.degraded is not None
                               and result.degraded.any()):
        kinds = sorted({e["kind"] for e in (result.fault_log or ())})
        print(f"[runctl] faults ({result.fault_policy} policy): "
              f"{result.workers_lost} worker(s) lost, "
              f"{int(result.degraded.sum())} job(s) released degraded; "
              f"fault log: {len(result.fault_log or ())} events "
              f"({', '.join(kinds)})")
    if result.verify_errors is not None:
        finite = result.verify_errors[np.isfinite(result.verify_errors)]
        if finite.size:
            print(f"[runctl] decode verified vs exact layered oracle: "
                  f"max rel error {finite.max():.2e}")
    print("[runctl] measured delay per resolution (seconds):")
    print(format_delay_table(delay_table(result)))
    if args.profile:
        print("[runctl] per-stage master pipeline breakdown:")
        print(format_stage_table(result))
        print("[runctl] omega controller trace:")
        print(format_controller_trace(result))

    if cfg.trace:
        from repro_torch.runtime import trace_export
        n_ev = len(result.trace_events or ())
        drop = (f" ({result.trace_dropped} dropped)"
                if result.trace_dropped else "")
        print(f"[runctl] trace: {n_ev} events{drop}")
        if result.clock_sync:
            worst = max(result.clock_sync,
                        key=lambda s: s["rtt_s"] or float("inf"))
            print(f"[runctl] clock sync: worst link {worst['host']} "
                  f"offset {worst['offset_s'] * 1e6:+.1f} us, "
                  f"rtt {(worst['rtt_s'] or 0.0) * 1e6:.1f} us "
                  f"(alignment error <= rtt/2)")
        if args.trace:
            path = pathlib.Path(args.trace)
            path.parent.mkdir(parents=True, exist_ok=True)
            trace_export.write_chrome_trace(path, result)
            print(f"[runctl] wrote {path} (load in Perfetto or "
                  f"chrome://tracing)")
        if args.trace_jsonl:
            path = pathlib.Path(args.trace_jsonl)
            path.parent.mkdir(parents=True, exist_ok=True)
            trace_export.write_jsonl(path, result)
            print(f"[runctl] wrote {path}")
        if args.metrics_out:
            path = pathlib.Path(args.metrics_out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(trace_export.prometheus_snapshot(result))
            print(f"[runctl] wrote {path}")
        if args.timeline:
            print(trace_export.format_timeline(result))

    if args.compare_sim:
        scfg = cfg.to_system_config()
        sim = simulator.simulate(scfg, args.sim_jobs, layered=True,
                                 deadline=cfg.deadline, seed=cfg.seed)
        bounds = simulator.theory_bounds(scfg, sim.service_moments(),
                                         layered=True)
        print(f"[runctl] simulator ({args.sim_jobs} jobs, same config):")
        print(format_delay_table(delay_table(sim, bounds=bounds)))

    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(summarize(cfg, result), indent=2))
        print(f"[runctl] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
