"""Port parity: the paper's §IV figures (``repro_torch.examples.
hetero_cluster_sim``) against the reference's ``benchmarks/paper_figures.py``.

Each of the four figure functions runs in both packages at the sizes of
``run_all(fast=True)``, the port's writing its CSV under ``tmp_path`` and
the reference's too (its module-level ``RESULTS`` monkeypatched there; its
file is not edited).  Both run the same NumPy event simulator on the same
seeds, so the returned claim-checks and every CSV cell must agree to a
relative 1e-12 (the float formatting of the same doubles; in practice
the files are equal byte for byte).
"""

import csv
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch.examples import hetero_cluster_sim as port  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: figure -> (keyword arguments of run_all(fast=True), its CSV)
FIGURES = {
    "fig2a_delay_vs_redundancy": ({"num_jobs": 800},
                                  "fig2a_delay_vs_redundancy.csv"),
    "fig2b_job_realizations": ({}, "fig2b_realizations.csv"),
    "fig3a_delay_distribution": ({"num_jobs": 800},
                                 "fig3a_delay_distribution.csv"),
    "fig3b_success_rate": ({"num_jobs": 800}, "fig3b_success_rate.csv"),
}


@pytest.fixture
def reference(monkeypatch, tmp_path):
    """The reference's ``benchmarks.paper_figures`` writing under
    ``tmp_path/ref``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import paper_figures
    monkeypatch.setattr(paper_figures, "RESULTS", str(tmp_path / "ref"))
    return paper_figures


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, (bool, np.bool_)):
        assert bool(got) == bool(want)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("figure", sorted(FIGURES))
def test_figure_matches_reference(reference, tmp_path, figure):
    kwargs, name = FIGURES[figure]
    want = getattr(reference, figure)(**kwargs)
    got = getattr(port, figure)(**kwargs, out_dir=str(tmp_path / "port"))
    _close(got, want)
    got_rows = _rows(tmp_path / "port" / name)
    want_rows = _rows(tmp_path / "ref" / name)
    assert got_rows[0] == want_rows[0]
    assert len(got_rows) == len(want_rows)
    np.testing.assert_allclose(np.asarray(got_rows[1:], dtype=np.float64),
                               np.asarray(want_rows[1:], dtype=np.float64),
                               rtol=1e-12)


def test_main_writes_the_four_csvs_and_the_summary(tmp_path, capsys):
    assert port.main(["--fast", "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        name for _, name in FIGURES.values())
    out = capsys.readouterr().out
    assert "summary of paper-claim checks:" in out
    assert "Fig3b success@deadline=10" in out


def test_the_twin_imports_neither_jax_nor_the_reference():
    src = pathlib.Path(port.__file__).read_text()
    for name in ("jax", "repro.", "benchmarks"):
        assert f"import {name}" not in src and f"from {name}" not in src
