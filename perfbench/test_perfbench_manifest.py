"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names: found by name, so adding a cell or a metric is adding files."""

import json
import re
import shutil

import pytest

from perfbench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return mf.load()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells fits the driver's 43200 seconds
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_keys(bench):
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_setup_another_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in mf.metrics_for(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert mf.metrics_for(bench, w["name"], True), w["name"]


def test_each_layer_metric_moves_a_metric_its_cells_report(bench):
    for m in bench["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in
                                        bench["workloads"]]):
            e2e = [x["name"] for x in mf.metrics_for(bench, cell, False)]
            assert m["moves"] in e2e, (m["name"], cell)


def test_rooflines_have_a_whole_step_share_beside_them(bench):
    mfu = {(m["moves"], c) for m in bench["per_layer"] if "mfu" in m["name"]
           for c in m["workloads"]}
    for m in bench["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
            for c in m["workloads"]:
                assert (m["moves"], c) in mfu, (m["name"], c)


def test_every_named_file_is_there(bench):
    for w in bench["workloads"]:
        c = mf.cell(bench, w["name"])
        assert c["traffic"]["kind"] in ("serve", "train")
        assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
        entry = c["config_entry"]
        assert c["config"]["name"] == entry["name"]
        assert c["config"]["reduced"] == entry["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(mf.reader(m["name"])), m["name"]


def test_adding_a_cell_and_a_metric_is_adding_files(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(mf.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    added = json.loads(json.dumps(bench))
    traffic = json.loads((root / "perfbench/traffic/chat.json").read_text())
    traffic.update(batch=8, gen=64)
    (root / "perfbench/traffic/chat-small.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/limits/yi-6b.chat-small.json").write_text(
        (root / "perfbench/limits/yi-6b.chat.json").read_text())
    (root / "perfbench/metrics/batches.py").write_text(
        "def read(rec, ctx):\n    return len(rec['batches'])\n")
    added["workloads"].append({"name": "yi-6b.chat-small", "config": "yi-6b",
                               "traffic": "chat-small", "chips": 1,
                               "why": "smaller batches"})
    for m in added["end_to_end"]:
        if m["name"] == "tpot_ms":
            m["workloads"].append("yi-6b.chat-small")
    added["per_layer"].append({"name": "batches", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving entry", "moves": "tpot_ms",
                               "workloads": ["yi-6b.chat-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    loaded = mf.load(root)
    cell = mf.cell(loaded, "yi-6b.chat-small", root)
    assert cell["traffic"]["batch"] == 8
    names = [m["name"] for m in mf.metrics_for(loaded, "yi-6b.chat-small",
                                               True)]
    assert "batches" in names
    assert mf.reader("batches", root)({"batches": [1, 2, 3]}, {}) == 3
