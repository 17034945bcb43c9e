"""BENCHMARK.json against the benchmark's contract, and every configuration,
traffic mix, driver, metric and count file it names loads by its name."""

from __future__ import annotations

import os
import re

import pytest

from portbench.harness import bench

B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["portbench"] and B["command"] == ["python3", "portbench/run.py"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    names = [e["name"] for e in B["configs"] + B["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = bench.config(entry["name"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"] and len(entry["source"]) <= 200 and len(entry["why"]) <= 200
    assert any(w["config"] == entry["name"] for w in B["workloads"])


@pytest.mark.parametrize("entry", B["workloads"], ids=lambda e: e["name"])
def test_cell_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    cell = bench.cell(entry["name"])
    assert hasattr(bench.module("drivers", cell.traffic["driver"]), "Driver")
    assert cell.traffic["limits"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(bench.reader(metric["name"]).read)
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if metric in B["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in B["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in B["workloads"]}


COUNTS = sorted(f[:-3] for f in os.listdir(os.path.join(bench.BENCH_DIR, "counts"))
                if f.endswith(".py"))


@pytest.mark.parametrize("name", COUNTS)
def test_count_file(name):
    assert bench.counts(name).__doc__


def test_missing_name_fails():
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.cv")
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")


def test_files_named_from_names():
    for base, _, files in os.walk(bench.BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), bench.ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
