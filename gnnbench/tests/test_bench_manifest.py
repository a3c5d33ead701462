"""BENCHMARK.json's keys, names, units and limits, and every piece a
cell names found by its name."""

import json
import re

import pytest

from gnnbench import find, work
from gnnbench.harness import HERE, find_cell, load_json, loop_class
from gnnbench.loop import Loop
from gnnbench.reference import models
from gnnbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gnnbench/run.py"]
    assert BENCH["paths"] == ["gnnbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_directions():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_pieces(cell):
    c = find_cell(ROOT, cell)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    assert issubclass(loop_class(c), Loop)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
    assert c["limits"], "every cell has its limits"


def test_configs_list_their_cuts():
    for c in BENCH["configs"]:
        assert c["file"].startswith("gnnbench/")
        cfg = load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg, key
        assert any(c["name"] == w["config"] for w in BENCH["workloads"])


def test_pieces_are_files_found_by_name():
    """Each loop a traffic names and each model a configuration trains is a
    file of its own; a name without one stops the run."""
    for path in sorted((HERE / "traffic").glob("*.json")):
        loop = load_json(path)["loop"]
        assert (HERE / "loops" / f"{loop}.py").is_file(), loop
        assert find.module("loops", loop).LOOP.metric
    for c in BENCH["configs"]:
        teacher = load_json(ROOT / c["file"]).get("teacher")
        if teacher:
            assert work.model_work(teacher["model_name"])
            assert models.graph_forward(teacher["model_name"])
    with pytest.raises(FileNotFoundError, match="no loops/open_loop.py"):
        find.module("loops", "open_loop")
    with pytest.raises(ValueError, match="no reference forward for model"):
        models.graph_forward("APPNP")
