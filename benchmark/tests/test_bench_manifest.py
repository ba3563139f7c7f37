"""BENCHMARK.json against the benchmark's contract: its keys, names, units,
the files each entry names, and the metrics each cell reports."""

import json
import math
import os
import re

import pytest

from harness.cell import BENCH, NAME, Cell

ROOT = os.path.dirname(BENCH)
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == TOP
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for kind, lo, hi in (("configs", 1, 24), ("workloads", 1, 24), ("end_to_end", 1, 16),
                         ("per_layer", 1, 128)):
        assert lo <= len(MANIFEST[kind]) <= hi


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_their_keys_and_names(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert TEXT.match(e[key]), e[key]
        if kind == "configs":
            assert TEXT.match(e["source"]) and e["source"].startswith("https://")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key), key


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def test_configs_files_and_reductions():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert os.path.exists(os.path.join(BENCH, "configs", f"{c['name']}.ref.py"))
        assert os.path.exists(os.path.join(BENCH, "systems", f"{cfg['system']}.py"))


def test_cells_one_chip_each_pair_once_and_files_found():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(1 for w in MANIFEST["workloads"] if w["chips"] == 4)
    assert four <= max(1, math.floor(0.25 * len(pairs)))
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        cell = Cell(MANIFEST, w["name"])
        assert cell.traffic["unit"] in ("fold_step", "proof")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = Cell(MANIFEST, w["name"])
        e2e = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics("per_layer"), w["name"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for c in m.get("workloads", sorted(cells)):
            assert c in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"], (m["name"], c)


def test_every_metric_has_a_reader():
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            path = os.path.join(BENCH, "metrics", f"{m['name']}.py")
            assert os.path.exists(path), path


def test_layers_share_one_spelling():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(TEXT.match(x) for x in layers)
    assert len({x.lower() for x in layers}) == len(layers)


def test_file_names_use_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH):
        if "__pycache__" in dirpath or "/." in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
