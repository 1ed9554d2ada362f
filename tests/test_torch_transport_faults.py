"""Port parity: worker loss, and the hierarchical code family, on
``repro_torch.runtime``'s transports.

The liveness, socket-fault, degrade-policy and hierarchical cases of the
JAX package's ``tests/test_transport_conformance.py``, on the port:
straggler sub-tasks of the hierarchical family are banked rather than
purged on every backend, a lost worker process or worker host fails a
``fail-fast`` run promptly and is absorbed by a ``degrade`` run, a
severed connection recovers, a SIGKILLed arena attacher leaks no segment
under the port's ``lrt-`` prefix, and nothing hangs.  Process workers
are killed with a real ``SIGKILL``; socket cases own a private
:class:`~repro_torch.runtime.transport.socket_host.LocalCluster`.
"""

import collections
import dataclasses
import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_transport import (  # noqa: E402,F401
    BACKENDS_FULL, MU3, MU5, _await_worker_processes, _cfg, _real_backend,
    _run_stream_with_faults, _run_with_faults, _runtime_worker_processes,
    _runtime_worker_threads, bcfg, socket_cluster)
from repro_torch.runtime import (FusionNode, RoundContext,  # noqa: E402
                                 RuntimeConfig, TransportDeadError,
                                 make_transport, run_jobs, telemetry)
from repro_torch.runtime.transport import shm as shm_mod  # noqa: E402
from repro_torch.runtime.transport.socket_host import (  # noqa: E402
    LocalCluster)


class TestProcessLiveness:
    """A lost worker process must fail the run promptly, never hang it."""

    def test_dead_worker_raises_promptly(self):
        cfg = _cfg(backend="process", straggler="none")
        transport = make_transport(cfg, sink=lambda r: None)
        transport.start()
        try:
            transport.assert_alive()            # healthy: no-op
            victim = transport.processes[0]
            victim.terminate()                  # an OOM-kill stand-in
            victim.join(timeout=5.0)
            with pytest.raises(RuntimeError, match="died"):
                transport.assert_alive()
        finally:
            transport.shutdown()
        assert not _runtime_worker_processes()


class TestSocketFaults:
    """Fault injection against the socket backend: a dead host fails the
    run promptly, a severed connection recovers, and in neither case may
    fusion hang.  Each case owns a private LocalCluster — the injected
    faults would poison the session-shared one."""

    def _stalled_round(self, cluster):
        """A transport with one all-workers-stalled round in flight."""
        cfg = _cfg(backend="socket", hosts=cluster.hosts, straggler="stall",
                   stall_workers=(0, 1, 2), stall_seconds=30.0)
        fusion = FusionNode()
        transport = make_transport(cfg, sink=fusion.post)
        transport.start()
        code = cfg.code()
        rng = np.random.default_rng(1)
        a = rng.integers(0, 9, size=(16, 4)).astype(np.float64)
        b = rng.integers(0, 9, size=(16, 4)).astype(np.float64)
        X, Y = code.encode(a, b)
        ctx = RoundContext(0, 0)
        rf = fusion.begin_round(ctx, code.k)
        transport.submit_round(ctx, np.asarray(X), np.asarray(Y),
                               cfg.load_split())
        time.sleep(0.1)
        return transport, fusion, code, (a, b, X, Y), ctx, rf

    def test_sigkill_worker_host_fails_run_promptly(self):
        """SIGKILL a worker host mid-round: assert_alive must raise
        within seconds (EOF -> reconnect-or-fail), and the in-flight
        round must not hang fusion."""
        with LocalCluster(len(MU3)) as cluster:
            transport, fusion, code, _, ctx, rf = self._stalled_round(
                cluster)
            try:
                transport.assert_alive()          # healthy: no-op
                t0 = time.monotonic()
                cluster.kill(0)                   # SIGKILL, no goodbye
                deadline = t0 + 10.0
                while time.monotonic() < deadline:
                    try:
                        transport.assert_alive()
                    except RuntimeError as e:
                        assert "died" in str(e)
                        break
                    time.sleep(0.05)
                else:
                    pytest.fail("dead host never detected")
                detect = time.monotonic() - t0
                assert detect < 8.0, f"detection took {detect:.1f}s"
                assert not rf.wait(timeout=0.0)   # round is dead, not hung
                transport.purge_round(ctx)
            finally:
                # shutdown with a dead member must neither hang nor leak;
                # it may report the host that cannot answer
                try:
                    transport.shutdown(timeout=8.0)
                except RuntimeError as e:
                    assert "worker" in str(e)
            assert not _runtime_worker_threads()

    def test_severed_connection_purge_watermark_clears_round(self):
        """Sever connections during result return: the transport
        reconnects, the re-sent hello carries the purge watermark, and
        the next round fuses fast — the stalled round never zombies."""
        with LocalCluster(len(MU3)) as cluster:
            transport, fusion, code, (a, b, X, Y), ctx0, rf0 = \
                self._stalled_round(cluster)
            try:
                transport.sever_for_test(0)
                transport.sever_for_test(1)
                t0 = time.monotonic()
                transport.purge_round(ctx0)       # watermark rides hello
                assert not rf0.wait(timeout=0.0)
                ctx1 = RoundContext(0, 1)
                rf1 = fusion.begin_round(ctx1, code.k)
                kappa = transport._cfg.load_split()
                zero = [np.zeros(int(k)) for k in kappa]
                transport.submit_round(ctx1, np.asarray(X), np.asarray(Y),
                                       kappa, delays=zero)
                assert rf1.wait(timeout=10.0), \
                    "round after sever never fused"
                recover = time.monotonic() - t0
                assert recover < 5.0, f"recovery took {recover:.2f}s"
                transport.purge_round(ctx1)
                np.testing.assert_allclose(rf1.decode(code), a.T @ b,
                                           rtol=1e-9, atol=1e-6)
                transport.assert_alive()          # reconnected, not dead
            finally:
                transport.shutdown(timeout=8.0)
            assert not _runtime_worker_threads()


class TestDegradeConformance:
    """The survivable-runtime acceptance scenarios: under
    ``fault_policy="degrade"``, SIGKILLing workers mid-run must end in a
    decode-verified completion (``n - k`` kills) or a prompt degraded
    release (below-``k`` kills) — never a hang, never an exception.
    Process-backend workers are killed with a real ``SIGKILL`` (no
    cleanup handlers run); socket cases own a private 5-host cluster."""

    def _degrade_cfg(self, backend, hosts=None, **kw):
        kw.setdefault("mu", MU5)
        kw.setdefault("arrival_rate", 8.0)
        kw.setdefault("complexity", 8.0)
        kw.setdefault("fault_policy", "degrade")
        kw.setdefault("seed", 3)
        if backend == "socket":
            # fast liveness knobs: detection within ~1 s, single re-dial
            kw.setdefault("heartbeat_interval", 0.2)
            kw.setdefault("heartbeat_timeout", 1.0)
            kw.setdefault("reconnect_attempts", 1)
            kw["hosts"] = hosts
        return RuntimeConfig(backend=backend, **kw)

    def test_process_sigkill_n_minus_k_completes_verified(self):
        """The headline acceptance: kill ``n - k = 1`` of 5 process
        workers mid-run; the run completes every job at full resolution,
        decode-verified, with the loss in the fault log — zero
        exceptions, zero degraded releases."""
        cfg = self._degrade_cfg("process")

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.5)
            os.kill(procs[1].pid, signal.SIGKILL)

        res, _ = _run_with_faults(cfg, 20, inject)
        assert res.fault_policy == "degrade"
        assert res.workers_lost == 1
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 1
        assert res.success.all()
        assert not res.degraded.any()
        assert (res.released == cfg.num_layers - 1).all()
        assert np.nanmax(res.verify_errors) < 1e-9
        assert not _runtime_worker_processes()

    def test_process_shm_sigkill_completes_and_leaks_no_segments(self):
        """The zero-copy wire path under the same headline kill: a worker
        SIGKILLed while it holds live arena slots must not cost
        correctness (degrade absorbs the loss, decode verifies) nor leak
        a single ``/dev/shm`` segment — the master owns and unlinks every
        arena, dead attacher or not."""
        cfg = self._degrade_cfg("process", shm="on")
        prefix = f"lrt-{os.getpid():x}-"

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.5)
            os.kill(procs[1].pid, signal.SIGKILL)

        res, _ = _run_with_faults(cfg, 20, inject)
        assert res.workers_lost == 1
        assert res.success.all()
        assert not res.degraded.any()
        assert np.nanmax(res.verify_errors) < 1e-9
        assert res.transport_stats["shm_active"]
        assert res.transport_stats["arena_rounds"] > 0
        assert shm_mod.leaked_segments(prefix) == []
        assert not _runtime_worker_processes()

    def test_process_res0_deadline_success_survives_kill(self):
        """Acceptance: res-0 deadline success is *unchanged* while the
        fleet absorbs an ``n - k`` kill — the proportional geometry refit
        must keep ``T > k`` spare so the stalled survivor's tasks still
        purge instead of gating every round.  Deadline derived from a
        measured deadline-free baseline of the same regime (the same
        calibration the tier-1 deadline test uses)."""
        probe = self._degrade_cfg("process", arrival_rate=14.0,
                                  straggler="stall", stall_workers=(2,),
                                  stall_seconds=2.0, seed=1)
        base_res, _ = run_jobs(probe, num_jobs=6, K=64, M=8, N=8)
        deadline = max(0.030,
                       2.2 * float(base_res.layer_compute[:, 0].mean()))
        cfg = dataclasses.replace(probe, deadline=deadline, seed=0)

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.6)
            os.kill(procs[1].pid, signal.SIGKILL)

        res, _ = _run_with_faults(cfg, 20, inject)
        assert res.workers_lost == 1
        assert res.success_rate()[0] >= 0.9      # same slack as tier-1
        assert np.nanmax(res.verify_errors) < 1e-9
        assert not _runtime_worker_processes()

    def test_process_below_k_survivors_release_degraded_promptly(self):
        """Acceptance: killing down to ``S < k`` survivors releases every
        remaining job at its best-ready resolution, marked degraded, with
        the collapse in the fault log — promptly, not after a timeout."""
        cfg = self._degrade_cfg("process")
        marks: dict = {}

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.5)
            for wid in (1, 3):
                os.kill(procs[wid].pid, signal.SIGKILL)
            marks["killed_at"] = time.monotonic()

        res, _ = _run_with_faults(cfg, 20, inject, join_timeout=60.0)
        # "promptly": well under the 20-job arrival span, nowhere near
        # any heartbeat/backoff timeout regime
        assert time.monotonic() - marks["killed_at"] < 15.0
        assert res.workers_lost == 2
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 2
        assert "fleet-collapse" in kinds
        assert {e["worker"] for e in res.fault_log
                if e["kind"] == "quarantine"} == {1, 3}
        assert res.degraded.any()
        assert res.terminated[res.degraded].all()
        done = ~res.terminated
        if done.any():          # jobs finished before the kill verify
            assert np.nanmax(res.verify_errors[done]) < 1e-9
        assert not _runtime_worker_processes()

    def test_process_fail_fast_raises_typed_error(self):
        """The default policy's contract is *unchanged* by this PR — a
        SIGKILLed worker still fails the run, now with the typed
        :class:`TransportDeadError` (satellite: typed exceptions)."""
        cfg = self._degrade_cfg("process", fault_policy="fail-fast")

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.4)
            os.kill(procs[0].pid, signal.SIGKILL)

        with pytest.raises(TransportDeadError, match="died"):
            _run_with_faults(cfg, 20, inject)
        assert not _runtime_worker_processes()

    def test_socket_kill_revive_readmits_and_completes(self):
        """Acceptance: a SIGKILLed socket host restarted on its port is
        readmitted through the reconnect + hello/watermark resync path —
        quarantine then readmit in the fault log, geometry restored, and
        the whole stream decode-verified."""
        with LocalCluster(len(MU5)) as cluster:
            cfg = self._degrade_cfg("socket", hosts=cluster.hosts)

            def inject():
                time.sleep(1.2)
                cluster.kill(2)
                time.sleep(1.8)
                cluster.revive(2)

            # the stream runs on until the revived host (a fresh
            # interpreter, seconds to start under load) is back and the
            # master has had three re-dial intervals
            res, _ = _run_stream_with_faults(cfg, 80, inject,
                                             settle=3.0, join_timeout=180.0)
        assert res.workers_lost == 1
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 1
        assert "readmit" in kinds
        assert res.success.all()
        assert not res.degraded.any()
        assert np.nanmax(res.verify_errors) < 1e-9
        assert not _runtime_worker_threads()


def _hier_cfg(bcfg, backend, **kw):
    kw.setdefault("code_family", "hierarchical")
    kw.setdefault("levels", 2)
    return bcfg(backend, **kw)


#: backend -> measured res-0 compute (s) for the *hierarchical* family in
#: the deadline scenario's stall regime, deadline-free.  The polynomial
#: baseline above would mis-calibrate: grouped dispatch amortizes wire
#: round-trips and the per-level ``T`` differs, so the hierarchical rows
#: measure their own round.
_HIER_BASELINE: dict = {}


def _hier_baseline(backend, bcfg) -> float:
    if backend not in _HIER_BASELINE:
        cfg = _hier_cfg(bcfg, backend, arrival_rate=14.0, complexity=8.0,
                        straggler="stall", stall_workers=(2,),
                        stall_seconds=2.0, seed=1)
        res, _ = run_jobs(cfg, num_jobs=6, K=64, M=8, N=8)
        _HIER_BASELINE[backend] = float(res.layer_compute[:, 0].mean())
    return _HIER_BASELINE[backend]


@pytest.mark.parametrize("backend", BACKENDS_FULL)
class TestHierarchicalConformance:
    """Sub-task-granular conformance rows, identical over every backend:
    the hierarchical family completes decode-verified while *banking*
    straggler sub-tasks (never discarding them), keeps already-fused
    levels when a §IV deadline purges mid-group, and reconciles its
    sub-task ledger exactly against the telemetry event log."""

    def test_hier_stall_completes_and_salvages_subtasks(self, backend,
                                                        bcfg):
        """Under a hard stall every job still completes at full
        resolution (per-level redundancy purges the stalled worker's
        share), and the salvage ledger is *nonzero*: fast workers' deep-
        level sub-tasks land while the master still waits on the level-0
        frontier — work the task-granular family would have thrown away."""
        cfg = _hier_cfg(bcfg, backend, arrival_rate=14.0, complexity=8.0,
                        straggler="stall", stall_workers=(2,),
                        stall_seconds=2.0, seed=1)
        res, _ = run_jobs(cfg, num_jobs=6, K=64, M=8, N=8, verify=True)
        assert res.backend == _real_backend(backend)
        assert res.success.all()
        assert (res.released == cfg.num_layers - 1).all()
        assert not res.terminated.any()
        assert np.nanmax(res.verify_errors) < 1e-9
        stats = res.transport_stats
        assert stats["subtask_results"] > 0
        assert stats["salvaged_subtasks"] > 0
        assert stats["salvaged_subtasks"] <= stats["subtask_results"]
        assert not _runtime_worker_threads()
        assert not _runtime_worker_processes()

    def test_hier_deadline_purge_keeps_completed_levels(self, backend,
                                                        bcfg):
        """Purge-mid-level: a deadline that cuts jobs off inside a group
        must not cost the levels that already fused — terminated jobs
        still release a verified lower resolution (res-0 keeps its §IV
        success gap), with the same measured-baseline calibration and
        slack rationale as the task-granular deadline row above."""
        deadline = max(0.030, 2.2 * _hier_baseline(backend, bcfg))
        cfg = _hier_cfg(bcfg, backend, arrival_rate=14.0, complexity=8.0,
                        deadline=deadline, straggler="stall",
                        stall_workers=(2,), stall_seconds=2.0, seed=0)
        res, _ = run_jobs(cfg, num_jobs=20, K=64, M=8, N=8, verify=True)
        assert res.terminated.any()
        sr = res.success_rate()
        assert sr[0] >= 0.9
        assert sr[-1] < 1.0 and sr[-1] < sr[0]
        term = np.flatnonzero(res.terminated)
        assert (res.released[term] >= 0).mean() >= 0.9   # partials shipped
        assert np.nanmax(res.verify_errors) < 1e-9
        # res-0 still leads the final resolution; the *strict* per-layer
        # ordering of the task-granular row is deliberately not asserted:
        # a group's last levels are dispatched together and can fuse
        # within microseconds of each other (that concurrency is the
        # salvage mechanism, not a defect)
        md = res.mean_delay()
        assert md[0] < md[-1]
        assert res.transport_stats["salvaged_subtasks"] > 0

    def test_hier_subtask_ledger_reconciles_with_trace(self, backend,
                                                       bcfg):
        """The sub-task ledger is the trace, aggregated: every accepted
        grouped result is exactly one RESULT event, every fused level
        round accepted exactly ``k`` of them, every stale rejection is a
        STALE event, and worker task spans close ``done``/``purged`` in
        exact agreement with the counters.  (Deliberately *not* asserted:
        ``DISPATCH == stage_rounds`` — the grouped path emits one
        DISPATCH per group of ``levels`` rounds, which is the point.)"""
        cfg = _hier_cfg(bcfg, backend, arrival_rate=60.0, complexity=4.0,
                        straggler="none", trace=True, seed=0)
        res, _ = run_jobs(cfg, 5, K=16, M=4, N=4, verify=False)
        evs = res.trace_events
        assert evs is not None and res.trace_dropped == 0
        stats = res.transport_stats
        arrivals = [e for e in evs if e.kind == telemetry.RESULT]
        assert len(arrivals) == stats["subtask_results"]
        assert 0 <= stats["salvaged_subtasks"] <= stats["subtask_results"]
        assert sum(e.kind == telemetry.STALE for e in evs) == \
            res.stale_results
        # fused level rounds accepted exactly k sub-task results each
        per_round = collections.Counter((e.job, e.round) for e in arrivals)
        fused_keys = {(e.job, e.round) for e in evs
                      if e.kind == telemetry.FUSED}
        assert fused_keys
        assert all(per_round[key] == cfg.k for key in fused_keys)
        # worker task spans reconcile across the process/TCP boundary
        tasks = [e for e in evs if e.kind == telemetry.TASK]
        assert sum(e.label == "done" for e in tasks) == res.tasks_done
        assert sum(e.label == "purged" for e in tasks) == res.tasks_purged
        # one ROUND span per level round, one DISPATCH per *group*
        assert sum(e.kind == telemetry.ROUND for e in evs) == \
            res.stage_rounds
        dispatches = [e for e in evs if e.kind == telemetry.DISPATCH]
        assert dispatches and all(e.label == f"group+{cfg.levels}"
                                  for e in dispatches)
        assert len(dispatches) == res.stage_rounds // cfg.levels


class TestHierarchicalDegrade:
    """SIGKILL mid-level under ``fault_policy="degrade"``: the grouped
    dispatch path absorbs worker loss exactly like the task-granular
    family — an ``n - k`` kill completes decode-verified, a below-``k``
    collapse releases every job at its best level-complete resolution
    with the loss itemized in the fault log."""

    def _hcfg(self, **kw):
        kw.setdefault("mu", MU5)
        kw.setdefault("arrival_rate", 8.0)
        kw.setdefault("complexity", 8.0)
        kw.setdefault("fault_policy", "degrade")
        kw.setdefault("code_family", "hierarchical")
        kw.setdefault("levels", 2)
        kw.setdefault("shm", "off")
        kw.setdefault("seed", 3)
        return RuntimeConfig(backend="process", **kw)

    def test_hier_process_sigkill_mid_level_completes_verified(self):
        """Kill ``n - k = 1`` of 5 workers mid-run: its in-flight group
        slices are re-dispatched at the wait frontier and every job still
        completes at full resolution, decode-verified, loss itemized —
        with the salvage ledger intact across the quarantine."""
        cfg = self._hcfg()

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.5)
            os.kill(procs[1].pid, signal.SIGKILL)

        res, _ = _run_with_faults(cfg, 20, inject)
        assert res.workers_lost == 1
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 1
        assert res.success.all()
        assert not res.degraded.any()
        assert (res.released == cfg.num_layers - 1).all()
        assert np.nanmax(res.verify_errors) < 1e-9
        assert res.transport_stats["subtask_results"] > 0
        assert not _runtime_worker_processes()

    def test_hier_process_below_k_releases_best_level_itemized(self):
        """Kill down to ``S < k`` survivors mid-level: every remaining
        job releases promptly at its best level-complete resolution
        (whatever levels had fused when the fleet collapsed), marked
        degraded, with both quarantines and the collapse itemized — and
        everything that *was* released decode-verifies."""
        cfg = self._hcfg()
        marks: dict = {}

        def inject():
            procs = _await_worker_processes(len(MU5))
            time.sleep(0.5)
            for wid in (1, 3):
                os.kill(procs[wid].pid, signal.SIGKILL)
            marks["killed_at"] = time.monotonic()

        res, _ = _run_with_faults(cfg, 20, inject, join_timeout=60.0)
        assert time.monotonic() - marks["killed_at"] < 15.0
        assert res.workers_lost == 2
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 2
        assert "fleet-collapse" in kinds
        assert {e["worker"] for e in res.fault_log
                if e["kind"] == "quarantine"} == {1, 3}
        assert res.degraded.any()
        assert res.terminated[res.degraded].all()
        # every level-complete resolution that shipped decode-verifies
        shipped = res.released >= 0
        if shipped.any():
            assert np.nanmax(res.verify_errors[shipped]) < 1e-9
        assert not _runtime_worker_processes()
