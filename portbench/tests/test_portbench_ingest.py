"""The sl-cli-ingest cell at a tiny size on the CPU: the CLI's ``run()``
through the driver agrees with the plain reference, each fault fails its
number by 100x its limit (or reads a nonzero count where the limit is 0),
the control fails ``x_gap``, the readers return None where their function
was not called, and the stand-in returns what the program's runner returns."""

from __future__ import annotations

import importlib
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import control
from portbench.harness import bench
from portbench.reference import ingest as reference
from portbench.tests.tiny import run_tiny, tiny_cell

CELL = "sl-cli-ingest"
DRIVER = bench.module("drivers", "searchlight_cli")
LIMITS = tiny_cell(CELL)[1]["limits"]
READERS = ("sl_cli_host_s", "cli_scaler_s", "cli_upload_s", "cli_adjacency_s", "cli_write_s",
           "cli_host_peak_gib")


def context(record, trace=None):
    return SimpleNamespace(record=record, trace=trace)


def test_sound_run_streams_and_reads_its_metrics():
    drv, record, numbers = run_tiny(CELL)
    assert numbers["x_gap"] < LIMITS["x_gap"] / 10 and numbers["kept_mismatch"] == 0, numbers
    assert numbers["adjacency_misses"] == 0 and numbers["results_faults"] == 0, numbers
    assert record["streamed"] == [True] * record["calls"]
    assert record["readers"] == [3] * record["calls"]
    assert record["x_all_columns"] == [drv.n_kept] * record["calls"] and drv.n_kept < 162
    assert record["upload_bytes"][0] == 4 * drv.n_kept * (48 + 140 + 3)
    for name in READERS:
        assert bench.reader(name).read(context(record)) > 0, name
    assert bench.reader("sl_cli_host_s").read(context(record)) == pytest.approx(
        record["window_s"] / record["calls"])
    assert bench.reader("cli_h2d_gbps").read(context(record)) is None  # no trace
    trace = {"device_ops": [["Memcpy HtoD (Pinned -> Device)", 0.002], ["kernel", 1.0],
                            ["Memcpy HtoD (Pageable -> Device)", 0.002]]}
    assert bench.reader("cli_h2d_gbps").read(context(record, trace)) == pytest.approx(
        sum(record["upload_bytes"]) / 1e9 / 0.004)
    attempted, failed = drv.attempted_failed()
    assert attempted >= record["calls"] and failed == 0


@pytest.mark.parametrize("fault", sorted(DRIVER.FAULTS))
def test_fault_fails_its_number(fault, monkeypatch):
    for module, attr, plant in DRIVER.FAULTS[fault]:
        module = importlib.import_module(module)
        monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    _, _, numbers = run_tiny(CELL, seconds=0.0)
    number = DRIVER.FAULT_NUMBERS[fault]
    assert numbers[number] >= 100 * LIMITS[number] and numbers[number] > 0, numbers


def test_control_is_not_correct():
    drv, _, sound = run_tiny(CELL, seconds=0.0)

    def answers(sample):
        with control.tf32():
            return drv.reference(sample)
    numbers = drv.check(answers)
    assert numbers["x_gap"] > LIMITS["x_gap"] > sound["x_gap"], (numbers, sound)
    assert drv.check(drv.reference)["x_gap"] == 0.0  # the reference in its own place


def test_readers_return_none_where_nothing_was_called():
    config, traffic, kind = tiny_cell(CELL)
    drv = DRIVER.Driver(dict(config, stream_ingest="off"), traffic, 11, "cpu")
    drv.setup()
    record = drv.window(0.0)
    drv.release()
    assert record["streamed"] == [False] and record["readers"] == [0]
    for name in ("cli_scaler_s", "cli_upload_s"):
        assert bench.reader(name).read(context(record)) is None, name
    trace = {"device_ops": [["Memcpy HtoD (Pinned -> Device)", 0.002]]}
    assert bench.reader("cli_h2d_gbps").read(context(record, trace)) is None
    assert judged_correct(drv.check())  # the eager path's X_all is judged alike
    empty = {"window_s": 1.0, "calls": 0, "upload_bytes": [], "scaler_s": [], "upload_s": [],
             "adjacency_s": [], "write_s": [], "host_rise_bytes": []}
    for name in READERS + ("cli_h2d_gbps",):
        assert bench.reader(name).read(context(empty, trace)) is None, name


def judged_correct(numbers: dict) -> bool:
    return all(numbers[k] <= v for k, v in LIMITS.items())


def test_stand_in_keeps_the_runners_contract():
    """The program's own runner, at the tiny size, writes the files the
    stand-in makes ``run`` write: the same keys, shapes and metrics."""
    from multimodal_decoding_tpu_torch.decoding import searchlight

    config, traffic, _ = tiny_cell(CELL)
    drv = DRIVER.Driver(config, traffic, 12, "cpu")
    drv.setup()
    drv.pcfg.progress = False
    path = searchlight.run(drv.pcfg)[0]
    drv.release()
    with open(path, "rb") as f:
        results = pickle.load(f)
    with np.load(os.path.join(os.path.dirname(path), "null_distr.npz")) as z:
        nulls = {k: z[k] for k in z.files}
    outputs = config["runner_outputs"]
    assert list(results["score_maps"]) == list(outputs["main"])
    assert list(nulls) == outputs["null"]
    assert reference.schema_faults(results, nulls, len(drv.coords), drv.n_kept,
                                   config["n_neighbors"], list(outputs["main"]),
                                   outputs["null"], config["n_permutations_per_subject"]) == 0
    for m, n in outputs["main"].items():  # each accuracy a count over its comparisons
        counts = results["score_maps"][m].astype(np.float64) * n
        assert np.allclose(counts, np.round(counts), atol=1e-3), m


def test_neighbour_misses_allow_ties_at_the_kth_distance():
    coords = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [2, 0, 0], [0, 3, 0]], np.float32)
    kept = np.ones(5, dtype=bool)
    vertices = np.array([0])
    for row, misses in (([0, 1], 0.0), ([0, 2], 0.0), ([0, 3], 1.0), ([1, 2], 1.0),
                        ([0, 0], 1.0)):
        adjacency = np.tile(np.array(row), (5, 1))
        assert reference.neighbour_misses(coords, kept, adjacency, vertices, 2, 1e-9) == misses
    assert reference.neighbour_misses(coords, kept, np.zeros((4, 2)), vertices, 2, 1e-9) == 1.0


def test_reference_statistics():
    r = np.random.default_rng(0)
    train = r.normal(3.0, 2.0, (50, 6)).astype(np.float32)
    train[:, 4] = 1.5  # a constant column: scale 1
    mean, scale = reference.train_statistics(train, np.arange(6))
    assert np.allclose(mean, train.astype(np.float64).mean(axis=0))
    std = train.astype(np.float64).std(axis=0)
    assert scale[4] == 1.0 and np.allclose(np.delete(scale, 4), np.delete(std, 4))


def test_same_seed_same_caches():
    config, traffic, _ = tiny_cell(CELL)

    def train_cache(seed):
        drv = DRIVER.Driver(config, traffic, seed, "cpu")
        drv.setup()
        drv.release()
        return reference.load_betas(drv.caches["train"][0])
    a, b, c = train_cache(5), train_cache(5), train_cache(2 ** 31 + 5)
    assert np.array_equal(a, b, equal_nan=True) and not np.array_equal(a, c, equal_nan=True)
    assert np.isnan(a).any(axis=0).sum() == round(0.085 * a.shape[1])
