"""Port parity: the coded runtime (``repro_torch.runtime``).

The same jobs go through both packages' ``Master`` on host threads; the
port's ``cuda`` backend is held against the JAX package where a card is
present, and must refuse to construct where none is.
"""

import dataclasses
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.runtime as jr  # noqa: E402
import repro_torch.runtime as tr  # noqa: E402
from repro_torch.runtime.tasks import RoundContext, TaskResult  # noqa: E402


@pytest.fixture
def cuda_device():
    """Decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _result(job_id, round_idx, task_id, value, t=0.0):
    return TaskResult(job_id=job_id, round_idx=round_idx, task_id=task_id,
                      worker_id=0, value=value, finished_at=t)


def _configs(**kw):
    return (tr.RuntimeConfig(backend="thread", **kw),
            jr.RuntimeConfig(backend="thread", **kw))


# -- configuration -------------------------------------------------------------

def test_backends_and_default():
    assert tr.BACKEND_NAMES == ("thread", "process", "cuda", "socket")
    assert tr.RuntimeConfig().backend == "cuda"
    assert sorted(tr.BACKENDS) == ["cuda", "process", "socket", "thread"]
    for bad in ("jax", "rpc"):
        with pytest.raises(ValueError):
            tr.RuntimeConfig(backend=bad)
    assert not hasattr(tr.RuntimeConfig(), "use_jax_devices")
    assert tr.SHM_MODES == jr.SHM_MODES
    assert tr.FRAME_PROTOS == jr.FRAME_PROTOS


#: The reference's JAX-only alias for its ``jax`` backend.
NOT_PORTED_FIELDS = {"use_jax_devices"}


def test_config_fields_match_reference():
    t_fields = {f.name for f in dataclasses.fields(tr.RuntimeConfig)}
    j_fields = {f.name for f in dataclasses.fields(jr.RuntimeConfig)}
    assert NOT_PORTED_FIELDS <= j_fields
    assert t_fields == j_fields - NOT_PORTED_FIELDS
    for name in NOT_PORTED_FIELDS:
        with pytest.raises(TypeError):
            tr.RuntimeConfig(backend="thread", **{name: None})


@pytest.mark.parametrize("kw", [
    dict(mu=(400.0, 650.0, 380.0), omega=1.5),
    dict(mu=(385.95, 650.92, 373.40, 415.75, 373.98), omega=2.0, gamma=2.0),
    dict(mu=(500.0, 100.0), omega=1.25, complexity=3.0, m=3),
])
def test_load_split_and_system_config_equal(kw):
    tcfg, jcfg = _configs(**kw)
    np.testing.assert_array_equal(tcfg.load_split(), jcfg.load_split())
    np.testing.assert_array_equal(tcfg.load_split(total=9),
                                  jcfg.load_split(total=9))
    active = (0, tcfg.num_workers - 1)
    np.testing.assert_array_equal(tcfg.load_split(active=active),
                                  jcfg.load_split(active=active))
    assert (dataclasses.asdict(tcfg.to_system_config())
            == dataclasses.asdict(jcfg.to_system_config()))
    assert tcfg.code().num_tasks == jcfg.code().num_tasks


#: One case per transport field: (field, keyword arguments, accepted?).
#: Each is built by both packages, which must accept it alike or reject
#: it with the same message.
_HOSTS3 = ("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3")
TRANSPORT_FIELD_CASES = [
    ("hosts", dict(backend="socket", hosts=_HOSTS3), True),
    ("hosts", dict(backend="socket"), False),
    ("hosts", dict(backend="socket", hosts=_HOSTS3[:1]), False),
    ("hosts", dict(backend="socket", hosts=("a:1", "b:2", "noport")), False),
    ("hosts", dict(backend="thread", hosts=_HOSTS3), False),
    ("hosts", dict(backend="process", hosts=_HOSTS3), False),
    ("compress", dict(backend="thread", compress="zlib"), True),
    ("compress", dict(backend="thread", compress="gzip"), False),
    ("shm", dict(backend="process", shm="on"), True),
    ("shm", dict(backend="thread", shm="off"), True),
    ("shm", dict(backend="process", shm="bogus"), False),
    ("shm", dict(backend="thread", shm="on"), False),
    ("shm", dict(backend="process", shm="on", code_family="hierarchical",
                 levels=2), False),
    ("frame_proto", dict(backend="socket", hosts=_HOSTS3, frame_proto=2),
     True),
    ("frame_proto", dict(backend="socket", hosts=_HOSTS3, frame_proto=3),
     False),
    ("frame_proto", dict(backend="process", frame_proto=1), False),
    ("heartbeat_interval", dict(backend="thread", heartbeat_interval=0.0),
     False),
    ("heartbeat_timeout", dict(backend="thread", heartbeat_interval=1.0,
                               heartbeat_timeout=1.0), False),
    ("heartbeat_timeout", dict(backend="thread", heartbeat_interval=0.2,
                               heartbeat_timeout=1.0), True),
    ("reconnect_attempts", dict(backend="thread", reconnect_attempts=-1),
     False),
    ("reconnect_attempts", dict(backend="thread", reconnect_attempts=0),
     True),
    ("reconnect_backoff", dict(backend="thread", reconnect_backoff=0.0),
     False),
    ("reconnect_backoff_cap", dict(backend="thread", reconnect_backoff=0.5,
                                   reconnect_backoff_cap=0.1), False),
    ("reconnect_backoff_cap", dict(backend="thread", reconnect_backoff=0.5,
                                   reconnect_backoff_cap=0.5), True),
]


@pytest.mark.parametrize("field,kw,ok", TRANSPORT_FIELD_CASES,
                         ids=[f"{f}-{i}" for i, (f, _, _)
                              in enumerate(TRANSPORT_FIELD_CASES)])
def test_transport_field_validation_matches_reference(field, kw, ok):
    kw = dict(mu=(400.0, 650.0, 380.0), **kw)
    if ok:
        tcfg, jcfg = tr.RuntimeConfig(**kw), jr.RuntimeConfig(**kw)
        assert getattr(tcfg, field) == getattr(jcfg, field)
        return
    with pytest.raises(ValueError) as ours:
        tr.RuntimeConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jr.RuntimeConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_transport_field_defaults_match_reference():
    tcfg = tr.RuntimeConfig(backend="thread")
    jcfg = jr.RuntimeConfig(backend="thread")
    for f in dataclasses.fields(tr.RuntimeConfig):
        if f.name != "backend":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_invalid_configs_rejected_alike():
    for kw in (dict(straggler="bogus"), dict(stall_workers=(3,)),
               dict(omega=0.5), dict(levels=2),
               dict(code_family="hierarchical", levels=1),
               dict(straggler="shift")):
        for cls in (tr.RuntimeConfig, jr.RuntimeConfig):
            with pytest.raises(ValueError):
                cls(mu=(1.0, 2.0), backend="thread", **kw)


def test_make_jobs_identical_operands():
    tcfg, jcfg = _configs(mu=(400.0, 500.0), seed=5)
    tj = tr.make_jobs(tcfg, 4, K=32, M=8, N=6)
    jj = jr.make_jobs(jcfg, 4, K=32, M=8, N=6)
    for a, b in zip(tj, jj):
        np.testing.assert_array_equal(a.a, b.a)
        np.testing.assert_array_equal(a.b, b.b)
        assert a.arrival == b.arrival and a.job_id == b.job_id


def test_straggler_delays_identical_for_seed():
    tcfg, jcfg = _configs(mu=(400.0, 500.0, 600.0), straggler="exp",
                          complexity=4.0)
    ts = tr.StragglerModel(tcfg, np.random.default_rng(3))
    js = jr.StragglerModel(jcfg, np.random.default_rng(3))
    for w in range(3):
        np.testing.assert_array_equal(ts.sample(w, 7), js.sample(w, 7))


# -- fusion / purge units (mirroring tests/test_runtime.py) ------------------

def test_round_fuses_at_kth_result_and_drops_late():
    rf = tr.RoundFusion(RoundContext(0, 0), k=3)
    for t in range(3):
        assert rf.post(_result(0, 0, t, np.full((2, 2), t), t=1.0 + t))
    assert rf.wait(timeout=0.0)
    assert rf.fused_at == 3.0
    assert not rf.post(_result(0, 0, 3, np.zeros((2, 2))))


def test_purged_round_rejects_results():
    ctx = RoundContext(0, 0)
    rf = tr.RoundFusion(ctx, k=2)
    ctx.purge()
    assert not rf.post(_result(0, 0, 0, np.zeros((2, 2))))
    assert not rf.wait(timeout=0.0)


def test_round_decode_reconstructs_minijob_like_reference(rng):
    tcfg, jcfg = _configs(mu=(400.0, 500.0), omega=1.5)
    code = tcfg.code()
    a = rng.integers(0, 255, size=(32, 8)).astype(np.float64)
    b = rng.integers(0, 255, size=(32, 8)).astype(np.float64)
    X, Y = code.encode(a, b)
    rf = tr.RoundFusion(RoundContext(0, 0), k=code.k)
    jrf = jr.RoundFusion(jr.RoundContext(0, 0), k=code.k)
    for t in range(code.num_tasks - code.k, code.num_tasks):
        rf.post(_result(0, 0, t, X[t].T @ Y[t]))
        jrf.post(jr.TaskResult(job_id=0, round_idx=0, task_id=t,
                               worker_id=0, value=X[t].T @ Y[t],
                               finished_at=0.0))
    got = rf.decode(code)
    np.testing.assert_allclose(got, a.T @ b, rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(got, jrf.decode(jcfg.code()), rtol=1e-12)


def test_fusion_node_routes_and_counts_stale():
    node = tr.FusionNode()
    rf = node.begin_round(RoundContext(job_id=1, round_idx=2), k=1)
    node.post(_result(9, 9, 0, np.zeros((1, 1))))
    assert node.stale_results == 1
    node.post(_result(1, 2, 0, np.zeros((1, 1))))
    assert rf.wait(timeout=0.0)


def test_layered_result_best_resolution_scans_from_top():
    lr = tr.LayeredResult(job_id=0, num_layers=4)
    lr.mark_resolution(0, np.zeros((1, 1)), t=0.0)
    lr.mark_resolution(1, np.ones((1, 1)), t=1.0)
    assert lr.best_resolution() == 1
    lr.mark_resolution(3, np.full((1, 1), 3.0), t=2.0)
    assert lr.best_resolution() == 3
    np.testing.assert_array_equal(lr.result(), np.full((1, 1), 3.0))


def test_layered_result_readiness_and_release():
    lr = tr.LayeredResult(job_id=0, num_layers=3)
    assert lr.best_resolution() == -1
    with pytest.raises(RuntimeError):
        lr.result()
    lr.mark_resolution(0, np.ones((2, 2)), t=1.5)
    assert lr.resolution_ready(0) and not lr.resolution_ready(1)
    lr.release(terminated=True)
    assert lr.terminated and lr.released_resolution == 0
    np.testing.assert_array_equal(lr.result(), np.ones((2, 2)))


def test_layered_result_wait_unblocks_consumer():
    lr = tr.LayeredResult(job_id=0, num_layers=2)
    seen = {}

    def consumer():
        lr.wait_resolution(0, timeout=5.0)
        seen["value"] = lr.resolution(0)

    th = threading.Thread(target=consumer)
    th.start()
    lr.mark_resolution(0, np.full((1,), 7.0), t=0.0)
    th.join(timeout=5.0)
    assert seen["value"][0] == 7.0


# -- end to end ----------------------------------------------------------------

def test_run_jobs_thread_backend_verifies():
    cfg = tr.RuntimeConfig(mu=(400.0, 650.0, 380.0), arrival_rate=100.0,
                           complexity=0.2, straggler="exp", backend="thread",
                           seed=0)
    res, futures = tr.run_jobs(cfg, num_jobs=5, K=64, M=8, N=8, verify=True)
    assert res.backend == "thread"
    assert res.success.all() and (res.released == cfg.num_layers - 1).all()
    assert np.nanmax(res.verify_errors) <= 1e-9
    assert res.tasks_done > 0
    jobs = tr.make_jobs(cfg, 5, K=64, M=8, N=8)
    for job, lr in zip(jobs, futures):
        np.testing.assert_allclose(lr.result(), job.a.T @ job.b, rtol=1e-9)


def test_hierarchical_family_verifies():
    cfg = tr.RuntimeConfig(mu=(400.0, 650.0, 380.0), complexity=0.2,
                           backend="thread", code_family="hierarchical",
                           levels=2, seed=1)
    res, _ = tr.run_jobs(cfg, num_jobs=3, K=32, M=8, N=8, verify=True)
    assert np.nanmax(res.verify_errors) <= 1e-9
    assert res.transport_stats["subtask_results"] > 0


def _same_jobs(seed=2):
    jcfg = jr.RuntimeConfig(mu=(400.0, 650.0, 380.0), straggler="none",
                            backend="thread", arrival_rate=200.0, seed=seed)
    jobs = jr.make_jobs(jcfg, 3, K=48, M=8, N=12)
    rng = np.random.default_rng(seed)
    floats = (rng.normal(size=(48, 8)), rng.normal(size=(48, 12)))
    jobs.append(jr.JobSpec(job_id=3, a=floats[0], b=floats[1],
                           arrival=jobs[-1].arrival))
    return jobs


def _final(futures):
    return [np.asarray(lr.result()) for lr in futures]


def _assert_masters_agree(tres, tfut, jres, jfut):
    np.testing.assert_array_equal(tres.released, jres.released)
    for got, want in zip(_final(tfut), _final(jfut)):
        scale = max(float(np.abs(want).max()), 1.0)
        assert np.abs(got - want).max() <= 1e-12 * scale


def test_both_masters_agree_on_the_same_jobs():
    """Integer jobs and one float job (quantized in float32 by both)."""
    jobs = _same_jobs()
    kw = dict(mu=(400.0, 650.0, 380.0), straggler="none", seed=2)
    tres, tfut = tr.Master(tr.RuntimeConfig(backend="thread", **kw),
                           verify=True).run(jobs)
    jres, jfut = jr.Master(jr.RuntimeConfig(backend="thread", **kw),
                           verify=True).run(jobs)
    _assert_masters_agree(tres, tfut, jres, jfut)
    assert np.nanmax(tres.verify_errors) <= 1e-9


def test_master_quantizes_float64_operands_like_reference():
    job = _same_jobs()[-1]
    kw = dict(mu=(400.0, 650.0), backend="thread")
    tq = tr.Master(tr.RuntimeConfig(**kw))._prepare(job)
    jq = jr.Master(jr.RuntimeConfig(**kw))._prepare(job)
    for got, want in zip(tq, jq):
        np.testing.assert_array_equal(got, want)


def test_cuda_backend_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tr.RuntimeConfig(mu=(400.0, 500.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.make_transport(cfg, sink=lambda r: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.run_jobs(cfg, num_jobs=1, K=16, M=4, N=4)


@pytest.mark.cuda
def test_cuda_backend_matches_jax_master(cuda_device):
    del cuda_device
    jobs = _same_jobs()
    kw = dict(mu=(400.0, 650.0, 380.0), straggler="none", seed=2)
    tres, tfut = tr.Master(tr.RuntimeConfig(backend="cuda", **kw),
                           verify=True).run(jobs)
    jres, jfut = jr.Master(jr.RuntimeConfig(backend="thread", **kw),
                           verify=True).run(jobs)
    assert tres.backend == "cuda" and tres.tasks_done > 0
    _assert_masters_agree(tres, tfut, jres, jfut)
