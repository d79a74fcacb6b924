"""BENCHMARK.json and the files it names: every cell, configuration,
traffic kind, reference, counter and per-layer reader is found, and a new
cell is only new files and entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.lib.cell import ROOT, load_cell, load_json, metric_family, module

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in SPEC["configs"])
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_metric_keys():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]] + CELLS
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found(name):
    cell = load_cell(name)
    assert cell.entry["chips"] == 1 and len(cell.entry["why"]) <= 200
    assert hasattr(module("traffic", cell.traffic), "Traffic")
    ref = module("reference", cell.family)
    assert ref.state_shapes(cell.config["model"])
    assert module("counts", cell.family).forward_flops(cell.config["model"]) > 0
    assert set(cell.workload["limits"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(module("metrics", metric_family(m["name"])).read)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = load_json(ROOT / config["file"])
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] and len(config["why"]) <= 200
    assert data["dtype"] == "float32" and data["tf32"] is False


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A throwaway cell in another root: an entry in its BENCHMARK.json and a
    workload file; the traffic kind, configuration and metrics are found
    by name, and nothing of the checkout is edited."""
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "mixednet-score-8x2s", "config": "mixednet-okay-nabu",
                              "traffic": "score_batch", "chips": 1, "why": "a throwaway cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "mixednet-score-64x10s" in m.get("workloads", []):
            m["workloads"].append("mixednet-score-8x2s")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "workloads").mkdir(parents=True)
    shutil.copytree(ROOT / "benchmark" / "configs", tmp_path / "benchmark" / "configs")
    work = load_json(ROOT / "benchmark" / "workloads" / "mixednet-score-64x10s.json")
    work.update(streams=8, stream_seconds=2.0)
    (tmp_path / "benchmark" / "workloads" / "mixednet-score-8x2s.json").write_text(json.dumps(work))
    cell = load_cell("mixednet-score-8x2s", root=tmp_path)
    assert cell.workload["streams"] == 8 and cell.family == "mixednet"
    assert {m["name"] for m in cell.end_to_end} == {"score_audio_s_per_s", "setup_s"}
    assert "accept_ms.score" in {m["name"] for m in cell.per_layer}
