"""Port parity: every worker transport of ``repro_torch.runtime`` obeys
one contract, and decodes what the JAX package's runtime decodes.

The registry, wire-form, transport-contract and end-to-end cases of the
JAX package's ``tests/test_transport_conformance.py``, on the port's
``thread``, ``process`` (shared-memory arena off and on) and ``socket``
backends, with a ``cuda`` row that skips without a card.  The fault,
gateway, hierarchical and adaptive-omega cases of that file are in
``tests/test_torch_transport_faults.py`` and
``tests/test_torch_transport_gateway.py``; the helpers they share are in
``tests/_torch_transport.py``.

:class:`TestReferenceParity` holds the port against the JAX package: the
same seeded jobs decode, on every host backend, to the JAX package's
``thread`` results (every resolution within 1e-9 of its largest value,
the final one within 1e-9 relative of the exact product), and the wire
forms carry the same fields (a result envelope pickles byte for byte the
same).

The reference file's own summary follows.

Backend-conformance suite: every worker transport obeys one contract.

The runtime's correctness claims (§IV semantics, simulator agreement,
adaptive-ω behavior) must hold over *any* transport, not just the thread
pool they were first built on.  End-to-end cases run real workers
(threads, OS processes, or TCP worker hosts) with real coded matmuls;
keep delay scales well above per-round overhead so the measured
statistics are about the system, not the container's timer.
"""

import dataclasses
import pickle
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.runtime as jr  # noqa: E402
from _torch_transport import (  # noqa: E402,F401
    BACKENDS_WIRE, MU3, _cfg, _real_backend, _round_baseline,
    _runtime_worker_processes, _runtime_worker_threads, bcfg,
    socket_cluster)
from repro_torch.core import simulator  # noqa: E402
from repro_torch.runtime import (BACKENDS, FusionNode,  # noqa: E402
                                 RoundContext, RuntimeConfig, TaskResult,
                                 WireBatch, make_transport, run_jobs)
from repro_torch.runtime.master import Master, make_jobs  # noqa: E402

#: the wire rows plus the card: the ``cuda`` row skips without a GPU
BACKENDS_ALL = BACKENDS_WIRE + ("cuda",)


class TestRegistry:
    def test_registry_names_match_config_surface(self):
        assert set(BACKENDS) == {"thread", "process", "cuda", "socket"}
        for name, cls in BACKENDS.items():
            assert cls.name == name

    def test_unknown_backend_rejected_at_config(self):
        with pytest.raises(ValueError, match="backend"):
            _cfg(backend="rpc")
        with pytest.raises(ValueError, match="backend"):
            _cfg(backend="jax")

    def test_jax_alias_is_not_a_field(self):
        """The reference's ``use_jax_devices`` alias upgrades to its
        ``jax`` backend; the port has neither."""
        with pytest.raises(TypeError, match="use_jax_devices"):
            _cfg(use_jax_devices=True)

    def test_cuda_backend_refuses_without_gpu(self, monkeypatch):
        """``cuda`` (the default) never falls back to host BLAS."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert RuntimeConfig(mu=MU3).backend == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            make_transport(RuntimeConfig(mu=MU3), sink=lambda r: None)

    def test_socket_backend_config_validation(self):
        """hosts are required (one per worker), well-formed, and rejected
        with any other backend rather than silently ignored."""
        with pytest.raises(ValueError, match="host:port per worker"):
            _cfg(backend="socket")
        with pytest.raises(ValueError, match="host:port per worker"):
            _cfg(backend="socket", hosts=("127.0.0.1:1",))   # 1 for 3
        with pytest.raises(ValueError, match="not of the form"):
            _cfg(backend="socket", hosts=("a:1", "b:2", "noport"))
        with pytest.raises(ValueError, match="only meaningful"):
            _cfg(backend="thread", hosts=("127.0.0.1:1",) * 3)
        with pytest.raises(ValueError, match="compress"):
            _cfg(compress="gzip")
        _cfg(backend="socket", hosts=("a:1", "b:2", "c:3"))   # valid


class TestWireForms:
    def test_round_batch_wire_round_trip(self):
        ctx = RoundContext(job_id=3, round_idx=1)
        ctx.seq = 17
        X = np.arange(48, dtype=np.float64).reshape(6, 4, 2)
        wire = WireBatch(seq=ctx.seq, job_id=ctx.job_id,
                         round_idx=ctx.round_idx, first_task_id=2,
                         x=X[2:4], y=X[4:6], delays=np.zeros(2))
        back = pickle.loads(pickle.dumps(wire))
        assert (back.seq, back.job_id, back.round_idx) == (17, 3, 1)
        assert back.count == 2
        np.testing.assert_array_equal(back.x, X[2:4])
        # pickling a view must serialize just the slice, not the base
        assert back.x.base is None or back.x.base.shape == back.x.shape

    def test_task_result_wire_round_trip(self):
        r = TaskResult(job_id=1, round_idx=2, task_id=3, worker_id=4,
                       value=np.eye(2), finished_at=5.5)
        back = TaskResult.from_wire(r.to_wire())
        assert back == dataclasses.replace(r, value=back.value)
        np.testing.assert_array_equal(back.value, r.value)


@pytest.mark.parametrize("backend", BACKENDS_ALL)
class TestTransportContract:
    """Direct transport-level checks, no master loop involved."""

    def _round_trip(self, backend, cfg, kappa=None):
        """Submit one coded round through the bare transport; fuse + decode."""
        code = cfg.code()
        rng = np.random.default_rng(0)
        a = rng.integers(0, 255, size=(32, 8)).astype(np.float64)
        b = rng.integers(0, 255, size=(32, 8)).astype(np.float64)
        X, Y = code.encode(a, b)
        fusion = FusionNode()
        transport = make_transport(cfg, sink=fusion.post)
        transport.start()
        try:
            ctx = RoundContext(job_id=0, round_idx=0)
            rf = fusion.begin_round(ctx, code.k)
            transport.submit_round(ctx, np.asarray(X), np.asarray(Y),
                                   cfg.load_split() if kappa is None
                                   else kappa)
            assert rf.wait(timeout=30.0), "round never fused"
            transport.purge_round(ctx)
            np.testing.assert_allclose(rf.decode(code), a.T @ b,
                                       rtol=1e-9, atol=1e-6)
        finally:
            transport.shutdown()

    def test_round_trip_fuses_and_decodes(self, backend, bcfg):
        self._round_trip(backend, bcfg(backend, straggler="none"))

    def test_seq_stamped_monotonic(self, backend, bcfg):
        cfg = bcfg(backend, straggler="none")
        fusion = FusionNode()
        transport = make_transport(cfg, sink=fusion.post)
        transport.start()
        try:
            code = cfg.code()
            X = np.zeros((cfg.total_tasks, 8, 4))
            seqs = []
            for r in range(3):
                ctx = RoundContext(0, r)
                fusion.begin_round(ctx, code.k)
                transport.submit_round(ctx, X, X, cfg.load_split())
                seqs.append(ctx.seq)
                transport.purge_round(ctx)
            assert seqs == sorted(seqs) and len(set(seqs)) == 3
        finally:
            transport.shutdown()

    def test_purge_reclaims_delayed_workers_immediately(self, backend, bcfg):
        """A purge must interrupt a multi-second injected delay at once:
        the next round's fuse proves the workers came back."""
        cfg = bcfg(backend, straggler="stall", stall_workers=(0, 1, 2),
                   stall_seconds=30.0)
        fusion = FusionNode()
        transport = make_transport(cfg, sink=fusion.post)
        transport.start()
        try:
            code = cfg.code()
            rng = np.random.default_rng(1)
            a = rng.integers(0, 9, size=(16, 4)).astype(np.float64)
            b = rng.integers(0, 9, size=(16, 4)).astype(np.float64)
            X, Y = code.encode(a, b)
            # round 0: every worker stalls 30 s; purge instead of waiting
            ctx0 = RoundContext(0, 0)
            rf0 = fusion.begin_round(ctx0, code.k)
            transport.submit_round(ctx0, np.asarray(X), np.asarray(Y),
                                   cfg.load_split())
            time.sleep(0.05)
            t0 = time.monotonic()
            transport.purge_round(ctx0)
            assert not rf0.wait(timeout=0.0)
            # round 1 (no injected delay) fuses fast only if the purge
            # actually reclaimed the stalled workers
            cfg1 = dataclasses.replace(cfg, straggler="none")
            del cfg1  # delays are per-batch: submit with explicit zeros
            ctx1 = RoundContext(0, 1)
            rf1 = fusion.begin_round(ctx1, code.k)
            kappa = cfg.load_split()
            zero_delays = [np.zeros(int(k)) for k in kappa]
            transport.submit_round(ctx1, np.asarray(X), np.asarray(Y),
                                   kappa, delays=zero_delays)
            assert rf1.wait(timeout=10.0), "purged workers never reclaimed"
            reclaim = time.monotonic() - t0
            assert reclaim < 5.0, f"reclaim took {reclaim:.2f}s"
            transport.purge_round(ctx1)
        finally:
            transport.shutdown()

    def test_shutdown_leaks_nothing(self, backend, bcfg):
        cfg = bcfg(backend, straggler="none")
        transport = make_transport(cfg, sink=lambda r: None)
        transport.start()
        transport.shutdown()
        assert not _runtime_worker_threads()
        assert not _runtime_worker_processes()

    def test_purge_mode_shutdown_reclaims_inflight_round(self, backend, bcfg):
        """The ISSUE bugfix: shutting down with an un-purged, delay-bound
        round in flight must neither hang nor leak — queued tasks are
        deterministically counted as purged."""
        cfg = bcfg(backend, straggler="stall", stall_workers=(0, 1, 2),
                   stall_seconds=30.0)
        fusion = FusionNode()
        transport = make_transport(cfg, sink=fusion.post)
        transport.start()
        code = cfg.code()
        X = np.zeros((cfg.total_tasks, 8, 4))
        ctx = RoundContext(0, 0)
        fusion.begin_round(ctx, code.k)
        transport.submit_round(ctx, X, X, cfg.load_split())
        time.sleep(0.05)
        t0 = time.monotonic()
        transport.shutdown(timeout=10.0)   # never purged: drain=False path
        assert time.monotonic() - t0 < 5.0, "shutdown blocked on a stall"
        assert transport.tasks_purged == cfg.total_tasks
        assert transport.tasks_done == 0
        assert not _runtime_worker_threads()
        assert not _runtime_worker_processes()


@pytest.mark.parametrize("backend", BACKENDS_WIRE)
class TestEndToEndConformance:
    """The load-bearing runtime tests, identical over every backend."""

    def test_completes_and_decode_verifies(self, backend, bcfg):
        cfg = bcfg(backend, arrival_rate=100.0, complexity=0.2,
                   straggler="none", seed=0)
        res, futures = run_jobs(cfg, num_jobs=6, K=64, M=8, N=8, verify=True)
        assert res.backend == _real_backend(backend)
        if backend == "shm":
            # the zero-copy path actually carried the run
            assert res.transport_stats["shm_active"]
            assert res.transport_stats["arena_rounds"] > 0
        assert res.success.all()
        assert (res.released == cfg.num_layers - 1).all()
        assert not res.terminated.any()
        assert np.nanmax(res.verify_errors) < 1e-9
        assert not _runtime_worker_threads()
        assert not _runtime_worker_processes()

    def test_deadline_releases_verified_lower_resolution(self, backend, bcfg):
        """The §IV acceptance scenario per backend: a straggler plus a
        deadline the final resolution misses still releases a correct
        lower resolution, MSB-first delays ordered.

        The deadline is derived from a measured per-round baseline
        (:func:`_round_baseline`), not a wall-clock constant: 2.2x the
        deadline-free res-0 delay sits between one round (res-0, ~1x)
        and the final resolution (m^2 = 4 rounds, ~4x) whatever the host
        speed, where a fixed 30 ms flaked on loaded containers.

        Thresholds still carry slack (res-0 >= 0.9, not == 1.0): a tight
        deadline on a loaded container can cost an occasional
        res-0 — the claim under test is the qualitative §IV gap between
        res-0 and the final resolution, not a hard-real-time guarantee."""
        deadline = max(0.030, 2.2 * _round_baseline(backend, bcfg))
        cfg = bcfg(backend, arrival_rate=14.0, complexity=8.0,
                   deadline=deadline, straggler="stall", stall_workers=(2,),
                   stall_seconds=2.0, seed=0)
        res, _ = run_jobs(cfg, num_jobs=20, K=64, M=8, N=8, verify=True)
        assert res.terminated.any()
        sr = res.success_rate()
        assert sr[0] >= 0.9
        assert sr[-1] < 1.0 and sr[-1] < sr[0]
        term = np.flatnonzero(res.terminated)
        assert (res.released[term] >= 0).mean() >= 0.9   # partials shipped
        assert np.nanmax(res.verify_errors) < 1e-9
        assert np.all(np.diff(res.mean_delay()) > 0)

    def test_runtime_agrees_with_simulator(self, backend, bcfg):
        """Measured mean res-0 delay under exp stragglers agrees with
        simulate() on the same configuration — over any transport.

        Sized for the low-utilization regime (~37 ms/task delays,
        inter-arrival >> service): queueing amplifies *any* per-round
        overhead nonlinearly, and the process backend's IPC latency on a
        small container is ~2-3 ms/round of scheduler wake-ups, so the
        comparison must be about the order statistic the simulator
        models, not about M/G/1 sensitivity to the container's core
        count.  At this scale both backends sit within a few percent of
        the simulator (dev container: thread ~0.97x, process ~1.02x)."""
        cfg = bcfg(backend, arrival_rate=0.8, complexity=60.0,
                   straggler="exp", seed=2)
        res, _ = run_jobs(cfg, num_jobs=8, K=64, M=8, N=8)
        sim = simulator.simulate(cfg.to_system_config(), 4000, layered=True,
                                 seed=7)
        md, sd = res.mean_delay(), sim.mean_delay()
        assert md[0] == pytest.approx(sd[0], rel=0.30)
        assert np.all(np.diff(md) > 0) and np.all(np.diff(sd) > 0)


class TestCudaBackendSmoke:
    """The card's row: the reference's ``jax`` smoke, on ``cuda``."""

    def test_cuda_backend_runs_and_verifies(self, bcfg):
        cfg = bcfg("cuda", arrival_rate=100.0, complexity=0.2,
                   straggler="none", seed=0)
        res, _ = run_jobs(cfg, num_jobs=3, K=64, M=8, N=8, verify=True)
        assert res.backend == "cuda"
        assert res.success.all()
        # float64 on the card: as tight as host BLAS
        assert np.nanmax(res.verify_errors) < 1e-9
        assert not _runtime_worker_threads()


# -- parity with the JAX package's runtime ------------------------------------

@pytest.mark.parametrize("backend", BACKENDS_ALL)
class TestReferenceParity:
    def test_same_jobs_decode_like_reference(self, backend, bcfg):
        kw = dict(mu=MU3, arrival_rate=100.0, complexity=0.2,
                  straggler="exp", seed=4)
        cfg = bcfg(backend, **kw)
        jobs = make_jobs(cfg, 4, K=64, M=8, N=8)
        jcfg = jr.RuntimeConfig(backend="thread", **kw)
        jjobs = jr.make_jobs(jcfg, 4, K=64, M=8, N=8)
        for job, ref in zip(jobs, jjobs):
            np.testing.assert_array_equal(job.a, ref.a)
            np.testing.assert_array_equal(job.b, ref.b)
        res, futures = Master(cfg, verify=True).run(jobs)
        jres, jfutures = jr.Master(jcfg, verify=True).run(jjobs)
        assert res.backend == _real_backend(backend)
        np.testing.assert_array_equal(res.released, jres.released)
        assert np.nanmax(res.verify_errors) <= 1e-9
        for job, ours, theirs in zip(jobs, futures, jfutures):
            for level in range(cfg.num_layers):
                got = np.asarray(ours.resolution(level))
                want = np.asarray(theirs.resolution(level))
                scale = max(float(np.abs(want).max()), 1.0)
                assert np.abs(got - want).max() <= 1e-9 * scale
            exact = job.a.T @ job.b
            final = np.asarray(ours.result())
            assert (np.abs(final - exact).max()
                    <= 1e-9 * float(np.abs(exact).max()))

    def test_wire_forms_match_reference(self, backend):
        del backend   # the wire forms are the same on every row
        rng = np.random.default_rng(0)
        x, y = rng.normal(size=(2, 8, 4)), rng.normal(size=(2, 8, 3))
        fields = dict(seq=5, job_id=1, round_idx=2, first_task_id=3, x=x,
                      y=y, delays=np.zeros(2))
        ours, ref = WireBatch(**fields), jr.WireBatch(**fields)
        assert ([f.name for f in dataclasses.fields(ours)]
                == [f.name for f in dataclasses.fields(ref)])
        assert ours.count == ref.count == 2
        r = TaskResult(job_id=1, round_idx=2, task_id=3, worker_id=4,
                       value=x[0], finished_at=5.5)
        jr_r = jr.TaskResult(job_id=1, round_idx=2, task_id=3, worker_id=4,
                             value=x[0], finished_at=5.5)
        assert pickle.dumps(r.to_wire(), protocol=5) == \
            pickle.dumps(jr_r.to_wire(), protocol=5)
