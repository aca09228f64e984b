"""BENCHMARK.json keeps the contract, and every name in it is found."""
import json
import re

import pytest

from portbench import roofline
from portbench.harness import spec

BENCH = spec.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        own = spec.metrics_for(BENCH, cell, "end_to_end")
        assert "setup_s" in own and len(own) >= 2
        layer = spec.metrics_for(BENCH, cell, "per_layer")
        assert layer
        for name in layer:
            moves = next(m["moves"] for m in BENCH["per_layer"]
                         if m["name"] == name)
            assert moves in own, (cell, name)
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_configuration_and_mix_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    config = spec.config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert config["name"] == w["config"]
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]
    assert "assumed" in config
    kind = spec.kind(spec.traffic(w["traffic"])["kind"])
    assert all(callable(getattr(kind, f)) for f in
               ("setup", "call", "check", "on_port", "on_control"))


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(entry):
    mod = spec.metric(entry["name"])
    assert callable(mod.read)
    assert mod.UNIT == entry["unit"]
    assert mod.MOVES == entry.get("moves", entry["name"])
    if "layer" in entry:
        assert mod.LAYER == entry["layer"]


def test_k1_bytes_at_the_small_world_shapes():
    assert roofline.k1_bytes(4_194_304, 134_217_728, 32) == 1_728_053_512
    assert roofline.k2_bytes(4_194_304, 134_217_728, 32) \
        == roofline.csr_bytes(4_194_304, 134_217_728) + 4_194_304 * 32 * 4
    assert roofline.pregel_bytes(10, 0, "sum") == 11 * 8 + 10 * 4


def test_configs_are_json_with_their_sizes():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert {"graph", "spinner", "source", "reduced", "assumed"} <= set(data)
