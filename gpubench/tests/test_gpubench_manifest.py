"""BENCHMARK.json against the contract's shape: names, units, bounds, and
every cell's configuration, traffic and metric readers found by name."""

import json
import os
import re

import pytest

from gpubench import run

REPO = run.ROOT
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = run.cell_of(BENCH, cell)
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    c = cfgs[w["config"]]
    assert c["file"] == f"gpubench/configs/{w['config']}.json"
    assert os.path.exists(os.path.join(REPO, c["file"]))
    assert run.traffic_of(REPO, w["traffic"])["members"]
    for key in ("end_to_end", "per_layer"):
        for m in run.cell_metrics(BENCH, cell, key):
            if m["name"] != "setup_s":
                mod, _ = run.metric_module(REPO, m["name"])
                assert hasattr(mod, "read" if key == "per_layer"
                               else "read_window")
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in run.cell_metrics(BENCH, cell, "per_layer"):
        assert m["moves"] in e2e


def test_per_layer_layers_and_moves():
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
