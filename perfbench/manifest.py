"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is run from:

* ``configs/<config>.json`` (the configuration file ``BENCHMARK.json``
  names) with its plain reference ``reference/<reference>.py``;
* ``traffic/<traffic>.json``, the traffic mix's parameters;
* ``limits/<cell>.json``, the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py`` for each metric reported in the cell, a reader
  with ``read(rec, ctx) -> float | None``.

Adding a configuration, a traffic mix, a cell or a metric is adding its
files and its entry in ``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

__all__ = ["ROOT", "BENCH_DIR", "load", "cell", "metrics_for", "reader"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load(root: pathlib.Path = ROOT) -> dict:
    """The parsed ``BENCHMARK.json`` at ``root``."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """Everything a run of cell ``name`` reads: its entry, its
    configuration (file and entry), its traffic, its limits and its
    reference module."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    config = _json(root / entry["file"])
    bench = root / "perfbench"
    return {"workload": w, "config_entry": entry, "config": config,
            "traffic": _json(bench / "traffic" / f"{w['traffic']}.json"),
            "limits": _json(bench / "limits" / f"{name}.json"),
            "reference": importlib.import_module(
                f"perfbench.reference.{config['reference']}")}


def metrics_for(manifest: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (a metric without
    ``workloads`` is reported in every cell)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
