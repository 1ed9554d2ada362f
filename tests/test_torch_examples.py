"""Port parity: the example twins (``repro_torch.examples``) on the CPU.

Each example's ``main(["--device", "cpu", ...])`` runs at its smallest
size and must reach its closing "OK" line, so its own assertions hold.
Where the JAX package's example draws its inputs from NumPy (quickstart's
parts 1 and 3, runtime_deadline's simulated table), the printed lines
must equal the reference example's, run here beside it; the measured
runtime's numbers are the host's timing and are not compared.
"""

import importlib.util
import pathlib
import re

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.examples import (fault_tolerance, quickstart,  # noqa: E402
                                  runtime_deadline, serve_progressive,
                                  train_lm)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _reference(name):
    """The JAX package's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _part(text, n):
    """The lines of part ``n`` ("n) ..." up to the next rule)."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith(f"{n}) "))
    end = next((i for i in range(start, len(lines))
                if lines[i].startswith("====")), len(lines))
    return lines[start:end]


def _between(text, first, last):
    lines = text.splitlines()
    a = next(i for i, line in enumerate(lines) if first in line)
    b = next(i for i in range(a, len(lines)) if last in lines[i])
    return lines[a:b]


def test_quickstart_matches_the_reference(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "int64 host fusion bit-exact: True" in got
    assert got.rstrip().endswith("quickstart OK")
    ref = _reference("quickstart")
    ref.part1_layered_coded_matmul()
    ref.part3_deadline_simulation()
    want = capsys.readouterr().out
    for n in (1, 3):
        assert _part(got, n) == _part(want, n)


def test_runtime_deadline_simulated_table_matches_the_reference(capsys):
    assert runtime_deadline.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.rstrip().endswith("runtime_deadline OK")
    assert "thread workers" in got
    _reference("runtime_deadline").part2_runtime_vs_simulator()
    want = capsys.readouterr().out
    table = ("simulated (4000 jobs)", "first-resolution mean delay")
    assert _between(got, *table) == _between(want, *table)
    simulated = re.compile(r"vs simulated ([0-9.]+) ms")
    assert simulated.search(got)[1] == simulated.search(want)[1]


def test_serve_progressive_runs(capsys):
    assert serve_progressive.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^\s+(\d) +(\d) +([0-9.]+)%$", out, re.M)
    assert [(b, r) for b, r, _ in rows] == [(str(b), str(b))
                                            for b in (1, 2, 3, 4)]
    assert float(rows[-1][2]) == 100.0
    assert "decode graphs" not in out           # the CPU decodes eagerly
    assert out.rstrip().endswith("serve_progressive OK")


@pytest.fixture
def one_thread():
    """torch on one host thread: the 200 steps take ~12 s so, where a
    pool of threads beside other test processes' pools can take minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_lm_learns_the_chain(capsys, tmp_path, one_thread,
                                   monkeypatch):
    """The example's own flags at a CPU's size, on a 256-token vocabulary:
    at its 32768 a chain that size runs past what a CPU learns in a test."""
    monkeypatch.setattr(train_lm, "VOCAB", 256)
    assert train_lm.main([
        "--device", "cpu", "--steps", "200", "--d-model", "128",
        "--layers", "1", "--batch", "16", "--seq", "64",
        "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    assert capsys.readouterr().out.rstrip().endswith("train_lm OK")


def test_fault_tolerance_decodes_and_resumes(capsys):
    assert fault_tolerance.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    errors = [float(e) for e in re.findall(r"gradient error ([0-9.e+-]+)",
                                           out)]
    assert len(errors) == 4 and max(errors) < 1e-5
    assert "resumed and trained to step 40" in out
    assert out.rstrip().endswith("fault_tolerance OK")
