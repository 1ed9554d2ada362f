"""``runctl serve-gateway`` — drive the multi-tenant serving gateway.

Generates an open stream of layered requests (Poisson or bursty
inter-arrivals), submits each to a
:class:`~repro_torch.runtime.gateway.ServingGateway` with its own deadline,
and reports the per-request outcomes: admitted / down-resolved /
rejected at the G/G/1 admission bound, release resolution and slack at
the deadline fire, per-resolution deadline-success rates.  The
:class:`~repro_torch.runtime.gateway.GatewayStats` artifact lands in
``--json``.

Workers run on the card by default (``--backend cuda``); ``--backend
thread``, ``process`` or ``socket`` run them on host BLAS.

Examples::

    # 60 Poisson requests at 20 req/s, 60 ms deadlines, G/G/1 admission
    PYTHONPATH=src python -m repro_torch.launch.runctl serve-gateway \
        --requests 60 --rate 20 --deadline 0.06 --json gateway.json

    # bursty open traffic over a localhost socket fleet
    PYTHONPATH=src python -m repro_torch.launch.runctl serve-gateway \
        --backend socket --local-cluster --traffic bursty --requests 40
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from repro_torch.runtime import RuntimeConfig, ServingGateway
from repro_torch.runtime.tasks import BACKEND_NAMES

__all__ = ["main", "request_gaps"]


def request_gaps(kind: str, rate: float, n: int,
                 rng: np.random.Generator, *, burst_factor: float = 4.0,
                 period: float = 0.5) -> np.ndarray:
    """Inter-arrival gaps (seconds) for an open request stream.

    ``poisson`` is exponential at ``rate``.  ``bursty`` is on/off
    modulated Poisson at the *same mean rate*: each ``period`` opens with
    an on-window of ``period / burst_factor`` seconds during which
    arrivals come ``burst_factor`` times faster, then goes silent — the
    arrival SCV the G/G/1 bound charges for.
    """
    if kind == "poisson":
        return rng.exponential(1.0 / rate, size=n)
    if kind != "bursty":
        raise ValueError(f"unknown traffic kind {kind!r}")
    on = period / burst_factor
    gaps = np.empty(n)
    t = 0.0
    for i in range(n):
        g = rng.exponential(1.0 / (burst_factor * rate))
        pos = (t + g) % period
        if pos > on:               # landed in the off-window: hold the
            g += period - pos      # arrival until the next burst opens
        gaps[i] = g
        t += g
    return gaps


def _print_summary(stats) -> None:
    js = stats.to_json()
    print(f"[serve-gateway] submitted {stats.submitted}: "
          f"{stats.admitted} admitted ({stats.down_resolved} down-resolved), "
          f"{stats.rejected} rejected; released {stats.released}, "
          f"{stats.degraded} degraded")
    hist = ", ".join(f"res{k}:{v}" if k != "-1" else f"none:{v}"
                     for k, v in js["release_histogram"].items())
    print(f"[serve-gateway] release histogram: {hist or '(empty)'}")
    succ = "  ".join(f"res{l}={js['deadline_success'][str(l)]:.3f}"
                     for l in range(stats.num_layers))
    print(f"[serve-gateway] deadline success by resolution: {succ}")
    if js["mean_slack"] is not None:
        print(f"[serve-gateway] mean slack {js['mean_slack'] * 1e3:+.1f} ms"
              + (f", mean queue wait {js['mean_queue_wait'] * 1e3:.1f} ms"
                 if js["mean_queue_wait"] is not None else ""))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="runctl serve-gateway", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean request arrivals per second")
    ap.add_argument("--traffic", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--burst-factor", type=float, default=4.0,
                    help="bursty traffic: on-window speed-up (mean rate "
                         "is unchanged)")
    ap.add_argument("--burst-period", type=float, default=0.5,
                    help="bursty traffic: seconds per on/off cycle")
    ap.add_argument("--deadline", type=float, default=0.06,
                    help="per-request deadline, seconds from submit")
    ap.add_argument("--resolution", type=int, default=None,
                    help="requested resolution (default: final, 2m-2)")
    ap.add_argument("--min-resolution", type=int, default=0,
                    help="lowest acceptable resolution (-1 = best-effort)")
    ap.add_argument("--admission", choices=("gg1", "none"), default="gg1",
                    help="admission policy: gg1 prices each request "
                         "against the G/G/1 bound; none admits all")
    ap.add_argument("--safety", type=float, default=1.3,
                    help="admission estimate inflation factor")
    ap.add_argument("--mu", default="385.95,650.92,373.40,415.75,373.98",
                    help="comma list of worker service rates")
    ap.add_argument("--n1", type=int, default=2)
    ap.add_argument("--n2", type=int, default=2)
    ap.add_argument("--omega", type=float, default=1.5)
    ap.add_argument("--planes", "-m", type=int, default=2, dest="planes",
                    help="digit chunks m (L = 2m-1 resolutions)")
    ap.add_argument("--d", type=int, default=8, help="digit width, bits")
    ap.add_argument("--complexity", type=float, default=10.0)
    ap.add_argument("--straggler",
                    choices=("none", "exp", "stall", "shift", "burst"),
                    default="exp")
    ap.add_argument("--backend", choices=BACKEND_NAMES, default="cuda",
                    help="worker transport: cuda (thread workers whose "
                         "coded products run on the card), thread, process "
                         "or socket (host BLAS)")
    ap.add_argument("--hosts", default="",
                    help="socket backend: comma list of host:port worker "
                         "hosts (one per --mu entry)")
    ap.add_argument("--local-cluster", action="store_true",
                    help="socket backend: spawn localhost worker hosts")
    ap.add_argument("--fault-policy", choices=("fail-fast", "degrade"),
                    default="fail-fast")
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--N", type=int, default=8)
    ap.add_argument("--verify", action="store_true",
                    help="decode-verify every job against the layered "
                         "oracle (slow; test runs)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-request telemetry spans and write a "
                         "Chrome trace-event JSON here")
    ap.add_argument("--json", default=None, help="write GatewayStats here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.local_cluster and args.backend != "socket":
        ap.error("--local-cluster needs --backend socket")
    if args.backend == "socket" and not (args.hosts or args.local_cluster):
        ap.error("--backend socket needs --hosts or --local-cluster")

    mu = tuple(float(x) for x in args.mu.split(",") if x)
    cluster = None
    if args.local_cluster:
        from repro_torch.runtime.transport.socket_host import LocalCluster
        cluster = LocalCluster(len(mu))
    try:
        cfg = RuntimeConfig(
            mu=mu, arrival_rate=args.rate, n1=args.n1, n2=args.n2,
            omega=args.omega, m=args.planes, d=args.d,
            complexity=args.complexity, straggler=args.straggler,
            backend=args.backend,
            hosts=(cluster.hosts if cluster is not None
                   else tuple(h for h in args.hosts.split(",") if h)),
            fault_policy=args.fault_policy, trace=bool(args.trace),
            seed=args.seed)
        return _serve(args, cfg)
    finally:
        if cluster is not None:
            cluster.close()


def _serve(args: argparse.Namespace, cfg: RuntimeConfig) -> int:
    print(f"[serve-gateway] {cfg.num_workers} workers ({cfg.backend} "
          f"backend), L={cfg.num_layers} resolutions, "
          f"{args.requests} requests at ~{args.rate:g}/s ({args.traffic}), "
          f"deadline {args.deadline * 1e3:.1f} ms, "
          f"admission={args.admission}")
    rng = np.random.default_rng(cfg.seed)
    gaps = request_gaps(args.traffic, args.rate, args.requests, rng,
                        burst_factor=args.burst_factor,
                        period=args.burst_period)
    lim = 1 << (cfg.m * cfg.d - 2)
    gw = ServingGateway(cfg, admission=args.admission, safety=args.safety,
                        verify=args.verify).start()
    tickets = []
    try:
        for i in range(args.requests):
            time.sleep(float(gaps[i]))
            a = rng.integers(-lim, lim, size=(args.K, args.M),
                             dtype=np.int64)
            b = rng.integers(-lim, lim, size=(args.K, args.N),
                             dtype=np.int64)
            tickets.append(gw.submit(a, b, deadline=args.deadline,
                                     resolution=args.resolution,
                                     min_resolution=args.min_resolution))
    finally:
        stats = gw.stop()
    stats.reconcile()
    _print_summary(stats)
    result = gw.result
    if args.trace and result is not None and result.trace_events:
        from repro_torch.runtime import trace_export
        path = pathlib.Path(args.trace)
        path.parent.mkdir(parents=True, exist_ok=True)
        trace_export.write_chrome_trace(path, result)
        print(f"[serve-gateway] wrote {path} "
              f"({len(result.trace_events)} events)")
    if args.json:
        out = {
            "config": {
                "mu": list(cfg.mu), "rate": args.rate,
                "traffic": args.traffic, "deadline": args.deadline,
                "admission": args.admission, "safety": args.safety,
                "m": cfg.m, "d": cfg.d, "omega": cfg.omega,
                "straggler": cfg.straggler, "backend": cfg.backend,
                "requests": args.requests, "seed": cfg.seed,
            },
            "gateway": stats.to_json(),
            "fleet": (None if result is None else {
                "backend": result.backend,
                "tasks_done": int(result.tasks_done),
                "tasks_purged": int(result.tasks_purged),
                "stale_results": int(result.stale_results),
                "workers_lost": int(result.workers_lost),
                "wall_elapsed": float(result.wall_elapsed),
            }),
        }
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=2))
        print(f"[serve-gateway] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
