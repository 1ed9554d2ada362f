"""Port parity: the command-line entry points (``repro_torch.launch.runctl``,
``serve_gateway``, ``worker_host``).

``runctl`` drives the port's runtime from the command line as the JAX
package's ``runctl`` drives its own: the same flags (less
``--jax-devices``), ``summarize`` writes the same keys, ``--compare-sim``
prints the same simulated table at the same seed, and ``serve-gateway``
and ``serve-worker`` run through it.  Every entry point defaults to the
``cuda`` backend and refuses to run without a card; the cases here name a
host backend (``thread``, ``process`` or ``socket``).
"""

import json
import os
import pathlib
import re
import select
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.launch import runctl as ref_runctl  # noqa: E402
from repro.launch import serve_gateway as ref_gateway  # noqa: E402
from repro_torch.launch import runctl, serve_gateway  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--jobs", "3", "--mu", "400,650,380", "--complexity", "2",
         "--arrival-rate", "50", "--K", "32", "--M", "8", "--N", "8",
         "--seed", "3"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _summary(main, argv, path, capsys):
    _run(main, argv + ["--json", str(path)], capsys)
    return json.loads(path.read_text())


def _keys(obj, prefix=""):
    """Every key path of a JSON object (lists of objects by first item)."""
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            out |= {f"{prefix}{k}"} | _keys(v, f"{prefix}{k}.")
        return out
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return _keys(obj[0], f"{prefix}[].")
    return set()


# -- flags --------------------------------------------------------------------

def _flags(module, capsys):
    """The option strings ``module.main(["--help"])`` lists."""
    with pytest.raises(SystemExit):
        module.main(["--help"])
    help_text = capsys.readouterr().out
    section = help_text[help_text.index("options:"):]
    return set(re.findall(r"^\s{2}(-\S+?)[,\s]", section, re.M)) | \
        set(re.findall(r", (--?\S+?)[,\s]", section))


def test_flags_are_the_reference_flags_less_jax_devices(capsys):
    ours = _flags(runctl, capsys)
    theirs = _flags(ref_runctl, capsys)
    assert {"--backend", "--shm", "--local-cluster", "--metrics-out",
            "-m", "--planes"} <= ours
    assert ours == theirs - {"--jax-devices"}


@pytest.mark.parametrize("main", (runctl.main, serve_gateway.main),
                         ids=("runctl", "serve-gateway"))
def test_backend_defaults_to_cuda_and_refuses_without_gpu(main,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--jobs", "1"] if main is runctl.main
            else ["--requests", "1"])
    with pytest.raises(RuntimeError) as err:
        main(argv + ["--K", "16", "--M", "4", "--N", "4"])
    # the gateway's master thread dies on it, and chains the cause
    cause = err.value.__cause__ or err.value
    assert "CUDA" in str(cause)


@pytest.mark.parametrize("argv", [
    ["--local-cluster"],
    ["--backend", "socket"],
    ["--backend", "socket", "--local-cluster", "--hosts", "a:1,b:2,c:3"],
    ["--straggler", "shift", "--stall-workers", "1"],
    ["--straggler", "burst"],
    ["--backend", "thread", "--jax-devices"],
], ids=("cluster-not-socket", "socket-no-hosts", "cluster-and-hosts",
        "shift-no-at", "burst-no-workers", "jax-devices"))
def test_contradictory_flags_rejected(argv, capsys):
    with pytest.raises(SystemExit) as err:
        runctl.main(argv)
    assert err.value.code == 2
    assert "error" in capsys.readouterr().err


def test_build_config_matches_reference():
    argv = SMALL + ["--backend", "process", "--shm", "off",
                    "--deadline", "0.05", "--straggler", "exp"]
    ours = runctl.build_config(_parse(runctl, argv))
    theirs = ref_runctl.build_config(_parse(ref_runctl, argv))
    mine = {k: v for k, v in vars(ours).items()}
    ref = {k: v for k, v in vars(theirs).items() if k != "use_jax_devices"}
    assert mine == ref


def _parse(module, argv):
    """The namespace ``module.main`` builds, without running anything."""
    captured = {}

    def grab(args, cfg):
        captured["args"] = args
        return 0

    real = module._run
    module._run = grab
    try:
        module.main(argv)
    finally:
        module._run = real
    return captured["args"]


# -- runs ---------------------------------------------------------------------

def test_summarize_has_the_reference_keys(tmp_path, capsys):
    argv = SMALL + ["--backend", "thread", "--deadline", "0.2"]
    ours = _summary(runctl.main, argv, tmp_path / "ours.json", capsys)
    theirs = _summary(ref_runctl.main, argv, tmp_path / "ref.json", capsys)
    assert _keys(ours) == _keys(theirs)
    assert ours["backend"] == "thread" and ours["num_jobs"] == 3
    assert ours["config"] == theirs["config"]
    assert ours["kappa"] == theirs["kappa"]
    assert ours["max_verify_rel_error"] < 1e-9


def _sim_table(printed):
    lines = printed.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("[runctl] simulator"))
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("[runctl]")), len(lines))
    return lines[start:end]


def test_compare_sim_table_equals_reference(capsys):
    argv = SMALL + ["--backend", "thread", "--compare-sim",
                    "--sim-jobs", "500", "--deadline", "0.05",
                    "--straggler", "exp"]
    ours = _sim_table(_run(runctl.main, argv, capsys))
    theirs = _sim_table(_run(ref_runctl.main, argv, capsys))
    assert len(ours) > 3
    assert ours == theirs


def test_profile_prints_stage_breakdown(capsys):
    out = _run(runctl.main, SMALL + ["--backend", "thread", "--profile"],
               capsys)
    assert "per-stage master pipeline breakdown" in out
    assert "omega controller trace" in out


@pytest.mark.parametrize("extra", [
    ["--backend", "process", "--shm", "on"],
    ["--backend", "process", "--shm", "off", "--code-family",
     "hierarchical", "--levels", "2"],
    ["--backend", "socket", "--local-cluster"],
], ids=("process-shm", "process-hier", "socket-local-cluster"))
def test_host_backends_verify(extra, tmp_path, capsys):
    out = _summary(runctl.main, SMALL + extra, tmp_path / "r.json", capsys)
    assert out["backend"] == extra[1]
    assert out["max_verify_rel_error"] < 1e-9
    assert out["transport_stats"]
    assert out["release_histogram"][-1] == 3


def _read_line(proc, timeout=60.0):
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, "worker host printed nothing"
    return proc.stdout.readline()


def test_serve_worker_hosts_drive_a_socket_run(tmp_path, capsys):
    """Three ``runctl serve-worker`` processes, named by ``--hosts``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.runctl", "serve-worker",
         "--port", "0", "--once"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True) for _ in range(3)]
    try:
        hosts = []
        for proc in procs:
            word, host, port = _read_line(proc).split()
            assert word == "LISTENING"
            hosts.append(f"{host}:{port}")
        out = _summary(runctl.main, SMALL + [
            "--backend", "socket", "--hosts", ",".join(hosts)],
            tmp_path / "s.json", capsys)
        assert out["backend"] == "socket"
        assert out["max_verify_rel_error"] < 1e-9
        assert out["transport_stats"]["frames_sent"] > 0
        for proc in procs:          # --once: each exits after the session
            assert proc.wait(timeout=30) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()


def test_serve_gateway_via_runctl_matches_reference_keys(tmp_path, capsys):
    argv = ["serve-gateway", "--backend", "thread", "--requests", "6",
            "--rate", "40", "--deadline", "5", "--K", "32", "--M", "8",
            "--N", "8", "--verify", "--seed", "1"]
    ours = _summary(runctl.main, argv, tmp_path / "g.json", capsys)
    theirs = _summary(ref_runctl.main, argv, tmp_path / "gr.json", capsys)
    assert _keys(ours) == _keys(theirs)
    gw = ours["gateway"]
    assert gw["submitted"] == 6 and gw["admitted"] == 6
    assert gw["released"] == 6 and gw["degraded"] == 0
    assert ours["fleet"]["backend"] == "thread"


def test_request_gaps_match_reference():
    for kind in ("poisson", "bursty"):
        np.testing.assert_array_equal(
            serve_gateway.request_gaps(kind, 20.0, 50,
                                       np.random.default_rng(2)),
            ref_gateway.request_gaps(kind, 20.0, 50,
                                     np.random.default_rng(2)))
