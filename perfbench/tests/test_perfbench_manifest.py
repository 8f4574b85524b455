"""BENCHMARK.json against the rules its format sets, and every piece
of every cell found by name."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)
    metric_names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert len(metric_names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


def test_bounds():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_and_configs():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == configs
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank"))]
        assert harness.config(c["name"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_layers_move(cell):
    e2e = {m["name"] for m in harness.metrics_for(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.metrics_for(cell, True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


def test_every_metric_and_cell_is_used():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]    # the harness needs the key
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert any(m in harness.metrics_for(c, "moves" in m) for c in cells)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {m["moves"] for m in BENCH["per_layer"]} <= e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_pieces_found_by_name(cell):
    w = harness.workload(cell)
    traffic = harness.traffic(w["traffic"])
    assert hasattr(harness.driver(traffic["driver"]), "run")
    assert _line(traffic["why"])
    limits = harness.limits(cell)
    assert limits and all("limit" in v for v in limits.values())
    for m in harness.metrics_for(cell, False) + harness.metrics_for(cell, True):
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_are_silent_without_their_source(metric):
    rec = {"setup_s": 1.0, "window_s": 2.0, "readings": {}}
    assert harness.reader(metric).read(rec) is None


def test_layers_name_the_same_layer_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
