"""Port parity: the serving gateway and adaptive omega over
``repro_torch.runtime``'s transports.

The gateway and adaptive-omega cases of the JAX package's
``tests/test_transport_conformance.py``, on the port's ``thread``,
``process`` and ``socket`` backends (and the shared-memory arena for the
adaptive case): overlapping requests multiplex one fleet, a mid-request
worker loss degrades only the affected request, and the omega
controller's signals travel over every transport.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_transport import (  # noqa: E402,F401
    BACKENDS_FULL, BACKENDS_WIRE, MU3, MU5, _await_worker_processes,
    _runtime_worker_processes, _runtime_worker_threads, bcfg,
    socket_cluster)
from repro_torch.runtime import RuntimeConfig, run_jobs  # noqa: E402
from repro_torch.runtime.transport.socket_host import (  # noqa: E402
    LocalCluster)


@pytest.mark.parametrize("backend", BACKENDS_WIRE)
class TestAdaptiveConformance:
    def test_adaptive_omega_signals_travel(self, backend, bcfg):
        """The ROADMAP transport-agnostic claim: RoundObservation signals
        (wait/stale/margin/utilization) drive the same ω retune loop over
        any backend — the regime-shift scenario recovers res-0 success."""
        base = bcfg(backend, arrival_rate=14.0, omega=1.0,
                    complexity=8.0, deadline=0.04, straggler="shift",
                    stall_workers=(2,), shift_at=0.6, stall_seconds=1.0,
                    adapt="fixed", seed=0)
        worst, _ = run_jobs(base, 24, K=64, M=8, N=8)
        adapt_cfg = dataclasses.replace(base, adapt="deadline-margin")
        adapt, _ = run_jobs(adapt_cfg, 24, K=64, M=8, N=8)
        sr_worst = worst.success_rate()[0]
        sr_adapt = adapt.success_rate()[0]
        assert sr_worst < 0.85           # the outage really binds at T = k
        assert sr_adapt >= sr_worst + 0.15
        ctl = adapt.controller
        assert ctl["switches"] >= 1 and ctl["omega_final"] > 1.0
        # utilization signal arrived over the transport (non-degenerate)
        assert adapt.worker_busy.shape == (len(MU3),)
        assert adapt.worker_busy.sum() > 0.0


class TestGatewayConformance:
    """The serving gateway over every transport: overlapping requests
    multiplex one shared fleet, and a mid-request worker loss under
    ``fault_policy="degrade"`` degrades only the affected request."""

    @staticmethod
    def _operands(rng, cfg, k=16, n=4):
        lim = 1 << (cfg.m * cfg.d - 2)
        a = rng.integers(-lim, lim, size=(k, cfg.n1 * n), dtype=np.int64)
        b = rng.integers(-lim, lim, size=(k, cfg.n2 * n), dtype=np.int64)
        return a, b

    @pytest.mark.parametrize("backend", BACKENDS_FULL)
    def test_two_overlapping_requests_both_decode_verify(self, backend,
                                                         bcfg):
        """Two requests in flight at once over one fleet — no restart
        between them — both released at full resolution with exact
        values (float64 roundoff rounded away)."""
        from repro_torch.runtime import ServingGateway

        cfg = bcfg(backend, arrival_rate=50.0, complexity=0.2,
                   straggler="none", seed=0)
        rng = np.random.default_rng(0)
        with ServingGateway(cfg, admission="none") as gw:
            a0, b0 = self._operands(rng, cfg)
            a1, b1 = self._operands(rng, cfg)
            t_a = gw.submit(a0, b0, deadline=30.0)
            t_b = gw.submit(a1, b1, deadline=30.0)   # queued behind A
            assert t_a.wait(timeout=60.0) and t_b.wait(timeout=60.0)
        full = cfg.num_layers - 1
        for t, want in ((t_a, a0.T @ b0), (t_b, a1.T @ b1)):
            assert t.released_resolution == full and not t.degraded
            np.testing.assert_array_equal(
                np.round(t.value()).astype(np.int64), want)
        # genuinely overlapping: B was admitted before A was released
        assert t_b.arrival < t_a.released_at
        gw.stats.reconcile()
        assert gw.result is not None and gw.result.backend == backend
        assert not _runtime_worker_threads()
        assert not _runtime_worker_processes()

    def test_process_sigkill_mid_stream_keeps_requests_full(self):
        """``n - k = 1`` process workers SIGKILLed while gateway requests
        stream through: the loss is absorbed (quarantine + refit) and
        every admitted request still releases at full resolution."""
        from repro_torch.runtime import ServingGateway

        cfg = RuntimeConfig(backend="process", mu=MU5, arrival_rate=8.0,
                            complexity=8.0, fault_policy="degrade",
                            straggler="none", seed=3)
        rng = np.random.default_rng(3)
        with ServingGateway(cfg, admission="none") as gw:
            procs = _await_worker_processes(len(MU5))
            tickets, oracles = [], []
            for i in range(8):
                a, b = self._operands(rng, cfg, k=64, n=4)
                oracles.append(a.T @ b)
                tickets.append(gw.submit(a, b, deadline=60.0))
                if i == 2:
                    os.kill(procs[1].pid, signal.SIGKILL)
                time.sleep(0.05)
        res = gw.result
        assert res.workers_lost == 1
        assert [e["kind"] for e in res.fault_log].count("quarantine") == 1
        full = cfg.num_layers - 1
        for t, want in zip(tickets, oracles):
            assert t.released_resolution == full and not t.degraded
            np.testing.assert_array_equal(
                np.round(t.value()).astype(np.int64), want)
        gw.stats.reconcile()
        assert not _runtime_worker_processes()

    def test_socket_sigkill_degrades_only_affected_request(self):
        """Below-``k`` SIGKILL mid-request over a socket fleet: the
        in-flight request is released degraded, and a request submitted
        after the hosts revive is readmitted onto the restored geometry
        and decode-verifies at full resolution — one gateway, one fleet,
        no restart."""
        from repro_torch.runtime import ServingGateway

        with LocalCluster(len(MU5)) as cluster:
            cfg = RuntimeConfig(
                backend="socket", hosts=cluster.hosts, mu=MU5,
                arrival_rate=8.0, complexity=8.0, fault_policy="degrade",
                straggler="stall", stall_workers=(0, 1, 2, 3, 4),
                stall_seconds=3.0, heartbeat_interval=0.5,
                heartbeat_timeout=5.0, reconnect_attempts=1, seed=3)
            rng = np.random.default_rng(3)
            with ServingGateway(cfg, admission="none") as gw:
                a0, b0 = self._operands(rng, cfg)
                t_a = gw.submit(a0, b0, deadline=60.0)
                time.sleep(0.4)             # A mid-round (3 s stall)
                cluster.kill(1)
                cluster.kill(3)             # survivors 3 < k = 4
                assert t_a.wait(timeout=30.0), "collapse never released A"
                assert t_a.degraded
                assert t_a.released_resolution < cfg.num_layers - 1
                cluster.revive(1)
                cluster.revive(3)
                time.sleep(1.5)             # > READMIT_INTERVAL
                a1, b1 = self._operands(rng, cfg)
                t_b = gw.submit(a1, b1, deadline=60.0)
                assert t_b.wait(timeout=60.0), "B never released"
                assert not t_b.degraded
                assert t_b.released_resolution == cfg.num_layers - 1
                np.testing.assert_array_equal(
                    np.round(t_b.value()).astype(np.int64), a1.T @ b1)
        res = gw.result
        assert res.workers_lost == 2
        kinds = [e["kind"] for e in res.fault_log]
        assert kinds.count("quarantine") == 2
        assert "fleet-collapse" in kinds
        assert "readmit" in kinds and "fleet-recovered" in kinds
        stats = gw.stats
        stats.reconcile()
        assert stats.degraded == 1          # only the affected request
        assert not _runtime_worker_threads()
