"""Shared fixtures and helpers of the port's transport-conformance files.

``tests/test_torch_transport_conformance.py``,
``tests/test_torch_transport_faults.py`` and
``tests/test_torch_transport_gateway.py`` hold the cases of the JAX
package's ``tests/test_transport_conformance.py`` on the port; they are
three files so that no one of them runs much longer than the others under
``--dist loadfile``.  Everything here is the reference file's own helper,
with two changes: configurations name their backend (the port's default
is ``cuda``, the reference's ``thread``), and the shared
:class:`~repro_torch.runtime.transport.socket_host.LocalCluster` lives
for one test module, not the whole session, so that a worker running
several of these files holds one cluster at a time.
"""

import multiprocessing
import threading
import time

import pytest

from repro_torch.runtime import RuntimeConfig, run_jobs
from repro_torch.runtime.transport.socket_host import LocalCluster

MU3 = (400.0, 650.0, 380.0)
#: five-worker fleet for the degrade-policy scenarios: k = 4, so one
#: SIGKILL is the "n - k workers" budget and two drop below k.
MU5 = (400.0, 650.0, 380.0, 420.0, 390.0)
BACKENDS_FULL = ("thread", "process", "socket")
#: wire-path rows: ``shm`` is the process backend with the shared-memory
#: arena forced on (``process`` rows pin it off so both wire paths stay
#: covered); it is a *config* of the process transport, not a registry
#: entry, so :func:`bcfg` translates it.
BACKENDS_WIRE = ("thread", "process", "shm", "socket")


def _real_backend(backend: str) -> str:
    return "process" if backend == "shm" else backend


@pytest.fixture(scope="module")
def socket_cluster():
    """One LocalCluster for every socket-parametrized case of a module:
    worker hosts serve sessions in a loop, so sequential runs just reuse
    them."""
    with LocalCluster(len(MU3)) as cluster:
        yield cluster


@pytest.fixture
def bcfg(request):
    """Config factory that knows how to target the shared socket cluster
    (and skips the ``cuda`` row where there is no card)."""

    def make(backend, **kw):
        kw.setdefault("mu", MU3)
        if backend == "shm":
            backend = "process"
            kw.setdefault("shm", "on")
        elif backend == "process":
            kw.setdefault("shm", "off")
        elif backend == "socket":
            kw.setdefault(
                "hosts", request.getfixturevalue("socket_cluster").hosts)
        elif backend == "cuda":
            import torch
            if not torch.cuda.is_available():
                pytest.skip("the cuda backend needs a CUDA device")
        return RuntimeConfig(backend=backend, **kw)

    return make


def _cfg(**kw):
    kw.setdefault("mu", MU3)
    kw.setdefault("backend", "thread")
    return RuntimeConfig(**kw)


#: backend -> measured res-0 delay (s) in the deadline scenario's stall
#: regime, deadline-free — cached once per session per backend.
_ROUND_BASELINE: dict = {}


def _round_baseline(backend, bcfg) -> float:
    """Measure how long one fused round actually takes on this machine.

    The §IV deadline case below needs a deadline that res-0 (one round)
    comfortably makes and the final resolution (m² rounds) reliably
    misses.  A fixed constant encodes one machine's speed; on a loaded CI
    container the same 30 ms can cost res-0 too and flake.  So run the
    identical stall regime without a deadline and read off the mean
    res-0 *compute* time — ``layer_compute[:, 0]``, seconds from service
    start, the same clock the deadline is measured on (delay would also
    count queueing wait, which the deadline does not) — the natural
    margin unit for that backend on this host.
    """
    if backend not in _ROUND_BASELINE:
        cfg = bcfg(backend, arrival_rate=14.0, complexity=8.0,
                   straggler="stall", stall_workers=(2,),
                   stall_seconds=2.0, seed=1)
        res, _ = run_jobs(cfg, num_jobs=6, K=64, M=8, N=8)
        _ROUND_BASELINE[backend] = float(res.layer_compute[:, 0].mean())
    return _ROUND_BASELINE[backend]


def _await_worker_processes(n, timeout=20.0) -> dict:
    """Wait for the master's ``n`` spawned worker processes; returns
    ``{worker_id: Process}`` so fault injection can pick its victim."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        procs = [p for p in multiprocessing.active_children()
                 if p.name.startswith("runtime-proc-worker-")]
        if len(procs) >= n:
            return {int(p.name.rsplit("-", 1)[1]): p for p in procs}
        time.sleep(0.02)
    pytest.fail(f"{n} worker processes never appeared")


def _run_with_faults(cfg, num_jobs, inject, join_timeout=120.0):
    """Run the master in a background thread while ``inject()`` applies a
    fault schedule from this one.

    A hang is the worst possible outcome of the survivable-runtime
    contract, so it is converted into a test failure here (bounded
    ``join``) rather than left to the CI-level timeout.  Exceptions the
    run raises are re-raised in the test thread.
    """
    holder: dict = {}

    def drive():
        try:
            holder["out"] = run_jobs(cfg, num_jobs, K=64, M=8, N=8,
                                     verify=True)
        except BaseException as e:
            holder["err"] = e

    t = threading.Thread(target=drive, daemon=True, name="fault-driver")
    t.start()
    inject()
    t.join(join_timeout)
    if t.is_alive():
        pytest.fail(f"run hung >{join_timeout:.0f}s under fault injection")
    if "err" in holder:
        raise holder["err"]
    return holder["out"]


def _run_stream_with_faults(cfg, min_jobs, inject, *, settle=3.0,
                            join_timeout=120.0):
    """:func:`_run_with_faults` with a stream that waits for what the
    fault schedule tests instead of for the clock.

    Jobs (:func:`make_jobs`' operands, Poisson at ``cfg.arrival_rate``)
    enter an open :class:`JobQueue` served by ``Master.serve_queue`` until
    at least ``min_jobs`` have arrived, ``inject()`` has returned and
    ``settle`` more seconds have passed; then the queue closes and the
    master drains it.  So a schedule that revives a worker host, whose
    fresh interpreter may take seconds to start under load, still has
    rounds running after it is back, for the master to re-dial it.  The
    whole run is bounded by ``join_timeout``.
    """
    import dataclasses

    import numpy as np

    from repro_torch.runtime import JobQueue, Master, make_jobs
    from repro_torch.runtime.worker import clock

    start = time.monotonic()
    master = Master(cfg, verify=True)
    queue = JobQueue()
    holder: dict = {}

    def drive():
        try:
            holder["out"] = master.serve_queue(queue)
        except BaseException as e:
            holder["err"] = e

    def fault():
        try:
            inject()
        except BaseException as e:
            holder["inject_err"] = e
        holder["injected_at"] = time.monotonic()

    t = threading.Thread(target=drive, daemon=True, name="fault-stream")
    t.start()
    while not master.started.wait(0.05):
        if not t.is_alive():
            raise holder.get("err") or RuntimeError("master never started")
    f = threading.Thread(target=fault, daemon=True, name="fault-inject")
    f.start()
    rng = np.random.default_rng(cfg.seed)
    # operands drawn in batches; arrival stamped on the master's clock
    gaps = rng.exponential(1.0 / cfg.arrival_rate, size=100_000)
    jobs, n = [], 0
    try:
        while time.monotonic() - start < join_timeout:
            injected = holder.get("injected_at")
            if (n >= min_jobs and injected is not None
                    and time.monotonic() - injected >= settle):
                break
            if not t.is_alive():
                break
            time.sleep(gaps[n % len(gaps)])
            if not jobs:
                jobs = make_jobs(cfg, 64, K=64, M=8, N=8, rng=rng)
            job = jobs.pop(0)
            queue.put(dataclasses.replace(
                job, job_id=n, arrival=clock() - master.t0))
            n += 1
    finally:
        queue.close()
    t.join(max(1.0, join_timeout - (time.monotonic() - start)))
    f.join(10.0)
    if t.is_alive():
        pytest.fail(f"run hung >{join_timeout:.0f}s under fault injection")
    if "inject_err" in holder:
        raise holder["inject_err"]
    if "err" in holder:
        raise holder["err"]
    return holder["out"]


def _runtime_worker_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("runtime-")]


def _runtime_worker_processes() -> list[str]:
    return [p.name for p in multiprocessing.active_children()
            if p.name.startswith("runtime-")]


