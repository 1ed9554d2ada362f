"""Port parity: the chaos suite, on ``repro_torch.runtime``.

The cases of the JAX package's ``tests/test_chaos_faults.py`` on the
port's ``process`` and ``socket`` backends: seeded schedules of SIGKILLs
of process workers and worker hosts (and revives of worker hosts) under
``fault_policy="degrade"``, with the invariants below checked on every
outcome.  ``fail-fast`` under the same kills is held in
:func:`test_fail_fast_chaos_raises_typed_error`.

The reference file's own summary follows.

Property-style chaos suite for the survivable runtime.

Each case draws a *random* fault schedule (seeded — reruns are
reproducible) of worker kills, and revives on the backend that supports
them, against a traced ``fault_policy="degrade"`` run, then checks
invariants that must hold for **every** outcome — whether that schedule
happened to be absorbed, re-dispatched around, or collapsed the fleet:

1.  No hang: the run returns within a bounded join, whatever was killed.
2.  No exception: degrade mode never raises, it quarantines.
3.  Exact event <-> counter reconciliation (requires ``trace_dropped ==
    0``): every QUARANTINE trace event is one ``workers_lost`` and one
    ``fault_log`` quarantine entry; every STALE event is one
    ``stale_results``.
4.  Fused rounds fused from exactly ``k`` accepted results; un-fused
    rounds accepted fewer (the fusion node's RESULT/STALE split).
5.  A purged round never fused (ROUND spans labelled ``purged`` have no
    FUSED instant) — the §IV invariant fault handling must not bend.
6.  Every released resolution decode-verifies against the layered
    oracle; ``degraded`` jobs are a subset of ``terminated`` ones.

Deliberately *not* asserted: how many jobs succeed, whether the fleet
collapsed, or how often re-dispatch fired — those are schedule- and
host-timing-dependent outcomes, exactly what a chaos test must not pin.

The cases are timing-robust but multi-second (real SIGKILLs, real TCP
hosts); CI runs them in their own timeboxed step outside tier-1.
"""

import dataclasses
import multiprocessing
import os
import random
import signal
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro_torch.runtime import (RuntimeConfig, TransportDeadError,  # noqa
                                 run_jobs, telemetry)
from repro_torch.runtime.transport.socket_host import (  # noqa: E402
    LocalCluster)

MU5 = (400.0, 650.0, 380.0, 420.0, 390.0)

FAULT_KINDS = {"quarantine", "readmit", "redispatch",
               "redispatch-exhausted", "fleet-collapse", "fleet-recovered"}


def _degrade_cfg(backend, hosts=None, seed=0):
    kw = dict(mu=MU5, arrival_rate=8.0, complexity=8.0, seed=seed,
              fault_policy="degrade", trace=True)
    if backend == "socket":
        kw.update(hosts=hosts, heartbeat_interval=0.2,
                  heartbeat_timeout=1.0, reconnect_attempts=1)
    return RuntimeConfig(backend=backend, **kw)


def _await_worker_processes(n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        procs = [p for p in multiprocessing.active_children()
                 if p.name.startswith("runtime-proc-worker-")]
        if len(procs) >= n:
            return {int(p.name.rsplit("-", 1)[1]): p for p in procs}
        time.sleep(0.02)
    pytest.fail(f"{n} worker processes never appeared")


def _run_under_chaos(cfg, num_jobs, inject, join_timeout=120.0):
    """Drive the master in a background thread, apply ``inject()`` from
    this one; a hang or an exception is a failure of invariant 1/2."""
    holder: dict = {}

    def drive():
        try:
            holder["out"] = run_jobs(cfg, num_jobs, K=64, M=8, N=8,
                                     verify=True)
        except BaseException as e:
            holder["err"] = e

    t = threading.Thread(target=drive, daemon=True, name="chaos-driver")
    t.start()
    inject()
    t.join(join_timeout)
    if t.is_alive():
        pytest.fail(f"run hung >{join_timeout:.0f}s under chaos schedule")
    if "err" in holder:
        pytest.fail(f"degrade-mode run raised: {holder['err']!r}")
    return holder["out"]


def _check_invariants(res, cfg):
    """The outcome-agnostic contract (module docstring, invariants 3-6)."""
    assert res.fault_policy == "degrade"
    assert res.trace_dropped == 0, "ring overflow voids reconciliation"
    events = res.trace_events or []
    by_kind: dict = {}
    for ev in events:
        by_kind.setdefault(ev.kind, []).append(ev)

    # 3. event <-> counter reconciliation, exact
    quarantines = by_kind.get(telemetry.QUARANTINE, [])
    log_kinds = [e["kind"] for e in (res.fault_log or [])]
    assert len(quarantines) == res.workers_lost \
        == log_kinds.count("quarantine")
    assert set(log_kinds) <= FAULT_KINDS
    assert len(by_kind.get(telemetry.STALE, [])) == res.stale_results

    # 4. fused rounds accepted exactly k results, un-fused fewer
    accepted: dict = {}
    for ev in by_kind.get(telemetry.RESULT, []):
        accepted[(ev.job, ev.round)] = accepted.get((ev.job, ev.round),
                                                    0) + 1
    fused = {(ev.job, ev.round) for ev in by_kind.get(telemetry.FUSED, [])}
    for jr, count in accepted.items():
        if jr in fused:
            assert count == cfg.k, f"round {jr} fused from {count} != k"
        else:
            assert count < cfg.k, f"round {jr} never fused with {count} >= k"

    # 5. purged rounds never fused
    purged = {(ev.job, ev.round)
              for ev in by_kind.get(telemetry.ROUND, [])
              if ev.label == "purged"}
    assert not (purged & fused), f"purged rounds fused: {purged & fused}"

    # 6. releases verify; degraded only ever via termination
    assert res.degraded is not None
    assert res.terminated[res.degraded].all()
    errs = res.verify_errors[res.released >= 0]
    if errs.size:
        assert np.nanmax(errs) < 1e-9


@pytest.mark.parametrize("seed", (11, 23))
def test_process_chaos_random_kills(seed):
    """SIGKILL a random subset of process workers at random instants."""
    rng = random.Random(seed)
    cfg = _degrade_cfg("process", seed=seed)
    n_kills = rng.choice((1, 2))
    schedule = sorted(rng.uniform(0.3, 1.6) for _ in range(n_kills))
    victims = rng.sample(range(len(MU5)), n_kills)

    def inject():
        procs = _await_worker_processes(len(MU5))
        start = time.monotonic()
        for at, wid in zip(schedule, victims):
            time.sleep(max(0.0, start + at - time.monotonic()))
            os.kill(procs[wid].pid, signal.SIGKILL)

    res, _ = _run_under_chaos(cfg, 20, inject)
    assert res.workers_lost >= 1       # the schedule really landed
    _check_invariants(res, cfg)
    assert not [p.name for p in multiprocessing.active_children()
                if p.name.startswith("runtime-")]


def test_socket_chaos_kill_and_revive():
    """Kill a random socket host mid-run, revive it after a random
    pause: whatever the master absorbed — quarantine only, or a full
    readmission — the reconciliation invariants hold."""
    rng = random.Random(7)
    with LocalCluster(len(MU5)) as cluster:
        cfg = _degrade_cfg("socket", hosts=cluster.hosts, seed=7)
        victim = rng.randrange(len(MU5))
        kill_at = rng.uniform(0.8, 1.5)
        revive_after = rng.uniform(1.5, 2.5)

        def inject():
            time.sleep(kill_at)
            cluster.kill(victim)
            time.sleep(revive_after)
            cluster.revive(victim)

        res, _ = _run_under_chaos(cfg, 40, inject, join_timeout=180.0)
    assert res.workers_lost >= 1
    _check_invariants(res, cfg)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("runtime-")]


def _hier_degrade_cfg(backend, hosts=None, seed=0):
    cfg = _degrade_cfg(backend, hosts=hosts, seed=seed)
    return dataclasses.replace(cfg, code_family="hierarchical", levels=2)


@pytest.mark.parametrize("backend", ("process", "socket"))
def test_hierarchical_chaos_salvage_ledger_holds(backend):
    """The sub-task-granular family under the same seeded chaos: the
    outcome-agnostic invariants 1-6 hold *unchanged* (invariant 4 reads
    "fused level rounds accepted exactly k sub-task results"), the
    salvage ledger stays well-formed — every accepted sub-task result is
    one RESULT event and the salvaged subset never exceeds it — and
    every released resolution decode-verifies, whatever mix of kills,
    re-dispatches, and (on socket) revives the schedule produced."""
    rng = random.Random(29)
    if backend == "process":
        cfg = _hier_degrade_cfg("process", seed=29)
        victims = rng.sample(range(len(MU5)), rng.choice((1, 2)))
        schedule = sorted(rng.uniform(0.3, 1.6) for _ in victims)

        def inject():
            procs = _await_worker_processes(len(MU5))
            start = time.monotonic()
            for at, wid in zip(schedule, victims):
                time.sleep(max(0.0, start + at - time.monotonic()))
                os.kill(procs[wid].pid, signal.SIGKILL)

        res, _ = _run_under_chaos(cfg, 20, inject)
    else:
        kill_at = rng.uniform(0.8, 1.5)
        revive_after = rng.uniform(1.5, 2.5)
        with LocalCluster(len(MU5)) as cluster:
            cfg = _hier_degrade_cfg("socket", hosts=cluster.hosts, seed=29)
            victim = rng.randrange(len(MU5))

            def inject():
                time.sleep(kill_at)
                cluster.kill(victim)
                time.sleep(revive_after)
                cluster.revive(victim)

            res, _ = _run_under_chaos(cfg, 40, inject, join_timeout=180.0)
    assert res.workers_lost >= 1       # the schedule really landed
    _check_invariants(res, cfg)
    stats = res.transport_stats
    n_results = sum(e.kind == telemetry.RESULT
                    for e in (res.trace_events or []))
    assert stats["subtask_results"] == n_results
    assert 0 <= stats["salvaged_subtasks"] <= stats["subtask_results"]
    released = res.released >= 0
    if released.any():
        assert np.nanmax(res.verify_errors[released]) < 1e-9
    assert not [p.name for p in multiprocessing.active_children()
                if p.name.startswith("runtime-")]
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("runtime-")]


@pytest.mark.parametrize("backend", ("process", "socket"))
def test_fail_fast_chaos_raises_typed_error(backend):
    """The default policy under the same kind of kill: a SIGKILLed
    process worker or worker host fails the run with the typed
    :class:`TransportDeadError`, promptly, on either backend."""
    rng = random.Random(31)

    def run(cfg, inject):
        holder: dict = {}

        def drive():
            try:
                run_jobs(cfg, 20, K=64, M=8, N=8, verify=True)
            except BaseException as e:
                holder["err"] = e

        t = threading.Thread(target=drive, daemon=True, name="chaos-driver")
        t.start()
        inject()
        t.join(60.0)
        assert not t.is_alive(), "fail-fast run hung after a kill"
        assert isinstance(holder.get("err"), TransportDeadError), holder
        assert "died" in str(holder["err"])

    if backend == "process":
        cfg = dataclasses.replace(_degrade_cfg("process", seed=31),
                                  fault_policy="fail-fast")

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(rng.uniform(0.3, 0.6))
            os.kill(procs[rng.randrange(len(MU5))].pid, signal.SIGKILL)

        run(cfg, inject)
    else:
        with LocalCluster(len(MU5)) as cluster:
            cfg = dataclasses.replace(
                _degrade_cfg("socket", hosts=cluster.hosts, seed=31),
                fault_policy="fail-fast")

            def inject():
                time.sleep(rng.uniform(0.3, 0.6))
                cluster.kill(rng.randrange(len(MU5)))

            run(cfg, inject)
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("runtime-")]
