"""Measured-run accounting, shaped like the simulator's ``SimResult``.

:class:`RuntimeResult` *is a* :class:`repro_torch.core.simulator.SimResult`
(same per-job arrays, same ``delay`` / ``mean_delay`` / ``success_rate``
semantics, times in seconds from the run start) so a measured run drops
straight into any analysis written for ``simulate()`` — in particular the
runtime-vs-simulator agreement checks and the paper's per-resolution delay
tables.  On top it records what only a real execution has: worker
occupancy, stale (purged-too-late) results, and per-layer decode-vs-oracle
verification errors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import simulator

__all__ = ["RuntimeResult", "delay_table", "format_delay_table",
           "format_stage_table", "format_controller_trace", "STAGES"]

#: Per-round pipeline stages the master accounts for.  ``wait`` is worker
#: compute (the master blocks on fusion); ``control`` is the ω-controller
#: (observation build + policy step + any geometry switch); everything
#: else is master-side critical-path overhead the pipelined engine works
#: to hide or shrink.
STAGES = ("prep", "encode", "dispatch", "wait", "decode", "publish",
          "control")


@dataclasses.dataclass
class RuntimeResult(simulator.SimResult):
    """Per-job outcome arrays of a measured runtime execution.

    Inherited (see ``SimResult``): arrivals, starts, ends, layer_compute,
    success, terminated, kappa — all wall-clock seconds relative to the run
    start.  Added:

    ``worker_busy[p]``   seconds worker p spent occupied (delay + compute).
    ``wall_elapsed``     run duration (last service end - run start).
    ``stale_results``    task results that arrived after their round fused.
    ``released[j]``      highest resolution released for job j (-1 = none).
    ``verify_errors``    (J, L) max relative decode error vs the exact
                         layered oracle, NaN where unverified/incomplete
                         (populated when the master runs with verify=True).
    ``stage_seconds``    total seconds per pipeline stage (see ``STAGES``)
                         across the run; decode/encode here are the
                         *observed* (pipelined) costs, so overlapped work
                         does not inflate the critical path it hid behind.
    ``stage_rounds``     rounds dispatched (the divisor for per-round
                         stage costs).
    ``controller``       the ω-controller's outcome summary (policy name,
                         initial/final omega, retune/switch counts, total
                         DecodePlan prime seconds) — present even for the
                         static ``fixed`` policy (zero retunes).
    ``omega_trace``      one dict per retune event (round, job, old/new
                         omega and T, new kappa, reason, prime seconds);
                         empty list when omega never moved.
    ``backend``          the worker transport that executed the run
                         (``thread`` / ``process`` / ``cuda`` /
                         ``socket``), for bench/JSON provenance.
    ``transport_stats``  wire-level counters for transports that cross a
                         network (socket backend: frames, dispatch/result
                         raw-vs-wire bytes, compression ratio); None for
                         in-process backends.
    ``tasks_done``       coded tasks computed and emitted across all
                         workers (exact: collected post-shutdown).
    ``tasks_purged``     tasks reclaimed by purges before completion.
    ``fault_policy``     the worker-loss policy the run executed under
                         (``fail-fast`` / ``degrade``).
    ``fault_log``        chronological fault-supervision record: one dict
                         per quarantine / readmit / redispatch /
                         fleet-collapse event (``t`` seconds from run
                         start, ``kind``, per-kind fields) — see
                         :mod:`repro_torch.runtime.faults`.  Empty when no
                         worker was lost.
    ``workers_lost``     distinct worker deaths the supervisor handled
                         (a readmitted-then-lost-again socket host
                         counts once per death).
    ``degraded``         (J,) bool: job was released by the fault
                         supervisor (fleet collapse or re-dispatch
                         budget exhausted) rather than finishing or
                         hitting the ordinary §IV deadline rule.
    ``trace_events``     time-sorted :class:`~repro_torch.runtime.telemetry.
                         TraceEvent` list when the run traced
                         (``cfg.trace=True``); None otherwise.  Remote
                         events are already rebased onto the master clock.
    ``trace_dropped``    events lost to tracer ring overflow (0 in any
                         sanely-sized run).
    ``trace_t0``         master monotonic-clock instant of the run start;
                         subtract from ``TraceEvent.t`` to get seconds
                         from run start (the exporters do this).
    ``clock_sync``       per-link clock alignment for networked backends:
                         a list of ``{worker, host, offset_s, rtt_s}``
                         dicts (offset error is bounded by ``rtt_s``);
                         None for in-process backends.

    ``kappa`` (inherited) is the eq. (1) split of the *initial* geometry;
    under an adaptive policy the per-retune splits live in
    ``omega_trace`` and the final one in ``controller``.
    """

    worker_busy: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    wall_elapsed: float = 0.0
    stale_results: int = 0
    released: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    verify_errors: np.ndarray | None = None
    stage_seconds: dict | None = None
    stage_rounds: int = 0
    controller: dict | None = None
    omega_trace: list | None = None
    backend: str = "thread"
    transport_stats: dict | None = None
    tasks_done: int = 0
    tasks_purged: int = 0
    fault_policy: str = "fail-fast"
    fault_log: list | None = None
    workers_lost: int = 0
    degraded: np.ndarray | None = None
    trace_events: list | None = None
    trace_dropped: int = 0
    trace_t0: float = 0.0
    clock_sync: list | None = None

    @property
    def utilization(self) -> np.ndarray:
        """Fraction of the run each worker spent occupied."""
        if self.wall_elapsed <= 0:
            return np.zeros_like(self.worker_busy)
        return self.worker_busy / self.wall_elapsed

    def per_round_overhead(self) -> float:
        """Master-side seconds/round (encode + decode, excluding worker
        wait and dispatch/publish) — the headline metric."""
        if not self.stage_seconds or not self.stage_rounds:
            return float("nan")
        s = self.stage_seconds
        return (s.get("encode", 0.0) + s.get("decode", 0.0)
                ) / self.stage_rounds

    def release_histogram(self) -> np.ndarray:
        """(L + 1,) job counts by released resolution; slot 0 = none (-1)."""
        L = self.layer_compute.shape[1]
        rel = np.asarray(self.released, dtype=np.int64)
        return np.bincount(rel + 1, minlength=L + 1)


def delay_table(result: simulator.SimResult,
                bounds: np.ndarray | None = None) -> list[dict]:
    """Per-resolution summary rows (the paper's Fig.-style table).

    Works for both simulated and measured results; ``bounds`` (optional)
    attaches the eq. (4) theoretical lower bounds per resolution.
    """
    mean = result.mean_delay()
    rate = result.success_rate()
    d = result.delay
    rows = []
    for l in range(d.shape[1]):
        ok = np.isfinite(d[:, l])
        row = {
            "resolution": l,
            "mean_delay": float(mean[l]),
            "p50_delay": float(np.median(d[ok, l])) if ok.any() else None,
            "p95_delay": (float(np.percentile(d[ok, l], 95))
                          if ok.any() else None),
            "success_rate": float(rate[l]),
        }
        if bounds is not None:
            row["theory_lower_bound"] = float(bounds[l])
        rows.append(row)
    return rows


def format_stage_table(result: "RuntimeResult") -> str:
    """Per-stage timing breakdown: total seconds, us/round, share."""
    if not result.stage_seconds or not result.stage_rounds:
        return "(no stage timings recorded)"
    s = result.stage_seconds
    total = sum(s.get(k, 0.0) for k in STAGES)
    lines = [f"{'stage':>9} {'total s':>10} {'us/round':>10} {'share':>7}"]
    for k in STAGES:
        v = s.get(k, 0.0)
        lines.append(f"{k:>9} {v:>10.4f} "
                     f"{v / result.stage_rounds * 1e6:>10.1f} "
                     f"{v / total:>7.1%}")
    ov = result.per_round_overhead()
    lines.append(f"master-side overhead (encode+decode): "
                 f"{ov * 1e6:.1f} us/round over {result.stage_rounds} rounds")
    return "\n".join(lines)


def format_controller_trace(result: "RuntimeResult",
                            max_rows: int = 24) -> str:
    """The ω-controller's retune history, fixed-width for CLI output."""
    ctl = result.controller
    if not ctl:
        return "(no controller summary recorded)"
    head = (f"policy={ctl['policy']}  omega {ctl['omega_initial']:.2f} -> "
            f"{ctl['omega_final']:.2f} (bounds "
            f"[{ctl['omega_bounds'][0]:.2f}, {ctl['omega_bounds'][1]:.2f}])"
            f"  retunes={ctl['retunes']}  geometry switches="
            f"{ctl['switches']}  plan prime total "
            f"{ctl['prime_seconds_total'] * 1e3:.2f} ms")
    trace = result.omega_trace or []
    if not trace:
        return head + "\n(omega never moved)"
    lines = [head,
             f"{'round':>6} {'job':>5} {'omega':>13} {'T':>7} "
             f"{'prime ms':>9}  reason"]
    shown = trace if len(trace) <= max_rows else trace[:max_rows]
    for ev in shown:
        omega = f"{ev['omega_old']:.2f}->{ev['omega_new']:.2f}"
        T = (f"{ev['T_old']}->{ev['T_new']}" if ev["switched"]
             else str(ev["T_old"]))
        lines.append(f"{ev['round']:>6} {ev['job']:>5} {omega:>13} {T:>7} "
                     f"{ev['prime_seconds'] * 1e3:>9.3f}  {ev['reason']}")
    if len(trace) > max_rows:
        lines.append(f"... ({len(trace) - max_rows} more retunes)")
    return "\n".join(lines)


def format_delay_table(rows: list[dict]) -> str:
    """Fixed-width rendering of :func:`delay_table` for CLI/bench output.

    An empty ``rows`` list (zero-resolution geometry or a run terminated
    before any release) renders a placeholder instead of crashing.
    """
    if not rows:
        return "(no resolutions to report)"
    has_bound = "theory_lower_bound" in rows[0]
    head = (f"{'res':>4} {'mean delay':>12} {'p50':>10} {'p95':>10} "
            f"{'success':>8}")
    if has_bound:
        head += f" {'eq.(4) bound':>13}"
    lines = [head]
    for r in rows:
        p50 = f"{r['p50_delay']:.4f}" if r["p50_delay"] is not None else "-"
        p95 = f"{r['p95_delay']:.4f}" if r["p95_delay"] is not None else "-"
        line = (f"{r['resolution']:>4} {r['mean_delay']:>12.4f} {p50:>10} "
                f"{p95:>10} {r['success_rate']:>8.3f}")
        if has_bound:
            line += f" {r['theory_lower_bound']:>13.4f}"
        lines.append(line)
    return "\n".join(lines)
