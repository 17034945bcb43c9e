"""The group-null cell at a tiny size on the CPU: the driver end to end with
the plain reference, each fault it can have failing ``null_max_gap`` by 100x
its limit, the bfloat16 control failing it, the reference's TFCE and
components against scipy and the program's TFCE, and the sweep's count and
readers against hand counts."""

from __future__ import annotations

import importlib
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from portbench import control
from portbench.harness import bench, surface
from portbench.reference import group as reference
from portbench.tests.tiny import run_tiny, tiny_cell

from multimodal_decoding_tpu_torch.ops import tfce as program_tfce  # noqa: E402

CELL = "group-null"
DRIVER = bench.module("drivers", "group_null")
LIMIT = tiny_cell(CELL)[1]["limits"]["null_max_gap"]


def test_sound_run_is_correct_and_reads_its_metrics():
    drv, record, numbers = run_tiny(CELL)
    assert numbers["null_max_gap"] <= LIMIT and numbers["t_gap"] < 1e-5, numbers
    total = tiny_cell(CELL)[0]["n_permutations_group_level"]
    assert numbers["sampled"] == min(tiny_cell(CELL)[1]["sample"], record["perms"], total)
    attempted, failed = drv.attempted_failed()
    assert attempted == record["perms"] > 0 and failed == 0
    per_call = tiny_cell(CELL)[1]["perms_per_call"]
    assert record["tfce_maps"] == 2 * per_call * record["calls"]
    assert record["chunks"] == len(record["sweep_chunks"]) == record["calls"] * 2 * 3
    ctx = SimpleNamespace(record=record, trace=None, config=drv.cfg, counts=bench.counts)
    rate = bench.reader("group_perms_per_s").read(ctx)
    assert rate == pytest.approx(record["perms"] / record["window_s"])
    assert bench.reader("group_tfce_ms").read(ctx) > 0
    for name in ("group_sweep_ms", "group_sweep_roofline_share", "group_device_idle_share"):
        assert bench.reader(name).read(ctx) is None


@pytest.mark.parametrize("fault", sorted(DRIVER.FAULTS))
def test_fault_fails_by_a_hundred_times_the_limit(fault, monkeypatch):
    for module, attr, plant in DRIVER.FAULTS[fault]:
        module = importlib.import_module(module)
        monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    _, _, numbers = run_tiny(CELL, seconds=0.0)
    assert numbers["null_max_gap"] >= 100 * LIMIT, numbers


def test_bf16_control_is_not_correct():
    drv, _, sound = run_tiny(CELL, seconds=0.0)

    def answers(rows):
        with control.tf32():
            return drv.reference(rows)
    numbers = drv.check(answers)
    assert numbers["null_max_gap"] > LIMIT > sound["null_max_gap"], (numbers, sound)
    assert drv.check(drv.reference)["null_max_gap"] <= LIMIT  # the reference in its own place


def test_permutations_are_itertools_order():
    for n, k in ((7, 3), (5, 5), (6, 1)):
        every = [list(p) for p in itertools.permutations(range(n), k)]
        assert [reference.permutation(r, n, k) for r in range(len(every))] == every
    first = list(itertools.islice(itertools.permutations(range(100), 6), 10000))
    for r in (0, 1, 93, 94, 9119, 9120, 9999):
        assert reference.permutation(r, 100, 6) == list(first[r])


def test_components_are_scipys():
    r = np.random.default_rng(3)
    n = 300
    a, b = r.integers(0, n, 260), r.integers(0, n, 260)
    label = reference.components(n, torch.as_tensor(a), torch.as_tensor(b)).numpy()
    _, want = connected_components(coo_matrix((np.ones(len(a)), (a, b)), shape=(n, n)),
                                   directed=False)
    assert np.array_equal(label[:, None] == label[None, :], want[:, None] == want[None, :])
    assert np.all(label <= np.arange(n))


def smooth_map(seed: int, subdivisions: int = 3) -> tuple:
    mesh = surface.hemispheres(subdivisions)
    edges = mesh["left"]["edges"]
    table = surface.neighbour_table(edges, len(mesh["left"]["coords"]))
    x = np.random.default_rng(seed).standard_normal(len(table))
    for _ in range(3):
        x = x[table].mean(axis=1)
    x = (2.5 * x / x.std()).astype(np.float32)
    x[:7] = np.nan
    return x, edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_tfce_is_the_programs(seed):
    values, edges = smooth_map(seed)
    ref = reference.tfce(torch.as_tensor(values), torch.as_tensor(edges), 2.0, 1.0, 0.1).numpy()
    assert ref.max() > 0
    for backend in ("numpy", "native"):
        got = program_tfce.tfce_map(values, edges, None, 2.0, 1.0, 0.1, backend=backend)
        assert np.max(np.abs(got - ref)) <= 1e-6 * ref.max(), backend


def test_bracket_holds_the_map_between():
    values, edges = smooth_map(5)
    t = torch.as_tensor(values, dtype=torch.float64)
    e = torch.as_tensor(edges)
    room = 0.05 * torch.clamp(t.abs(), min=1.0)
    lo, mid, hi = (reference.tfce(m, e, 2.0, 1.0, 0.1) for m in (t - room, t, t + room))
    assert torch.all(lo <= mid) and torch.all(mid <= hi) and hi.max() > lo.max()


def test_singleton_rule_is_strict():
    """A vertex alone at exactly a threshold gains nothing there: the rule
    ``>=`` in its place would move the map's maximum by 250x the limit.  The
    cell's float32 t-maps never carry a value equal to a threshold, so no run
    can see that fault; this crafted map does."""
    mesh = surface.hemispheres(1)
    edges = mesh["left"]["edges"]
    values = np.full(len(mesh["left"]["coords"]), -1.0, dtype=np.float32)
    values[0] = 0.5
    assert np.arange(0.1, 0.6, 0.1)[-1] == 0.5
    ref = reference.tfce(torch.as_tensor(values), torch.as_tensor(edges), 2.0, 1.0, 0.1)
    strict = sum((0.1 * k) ** 2 * 0.1 for k in range(1, 5))
    assert float(ref.max()) == pytest.approx(strict)
    for backend in ("numpy", "native"):
        got = program_tfce.tfce_map(values, edges, None, 2.0, 1.0, 0.1, backend=backend)
        assert got.max() == pytest.approx(strict, rel=1e-6)
    at_least = strict + 0.5 ** 2 * 0.1
    assert (at_least - float(ref.max())) / max(at_least, 1.0) >= 100 * LIMIT


def test_t_min_keeps_the_programs_nan_rules():
    x = torch.tensor([[0.5, 0.6, np.nan, 0.7], [0.5, 0.4, 0.5, 0.9], [0.5, 0.5, 0.5, 0.8]])
    y = torch.tensor([[0.5, 0.9, np.nan, 0.1], [0.5, 0.7, np.nan, 0.2], [0.5, 0.8, np.nan, 0.3]])
    t = reference.t_min([x, y], [0.5, 0.5]).numpy()
    assert np.isnan(t[0]) and np.isnan(t[2])  # all alike in both; NaN in both
    assert abs(t[1]) < 1e-5 and t[3] < 0  # the second member's t is lower


def test_sweep_count_by_hand():
    t = bench.counts("group_sweep").terms(4, 6, 256, 103, 10)
    assert t["gather"] == (0, 4 * 103 * 10 * 4)
    assert t["t_min_out"] == (0, 256 * 10 * 4)
    assert t["t_maps"] == (4 * 256 * 10 * 36, 0)
    drv = DRIVER.Driver({"n_subjects": 6, "n_permutations_per_subject": 100}, {}, 0, "cpu")
    drv.program_perms = np.array(list(itertools.islice(itertools.permutations(range(100), 6),
                                                       300)))
    # the first 256 tuples: subjects 0-3 keep maps 0-3, subject 4 takes 4, 5, 6,
    # subject 5 takes every map but those before it
    assert drv._distinct(np.arange(256)) == 4 + 3 + 96


def test_sweep_readers_by_hand():
    cfg = {"members": {"a": 0.5, "b": 0.5}, "n_subjects": 6, "n_vertices": 10}
    record = {"chunks": 4, "sweep_chunks": [[256, 103]] * 4, "perms": 512}
    trace = {"spans": {"portbench.group_null": {"count": 2, "kernel_s": 0.02}},
             "busy_s": 0.5, "window_s": 2.0}
    ctx = SimpleNamespace(record=record, trace=trace, config=cfg, counts=bench.counts)
    assert bench.reader("group_sweep_ms").read(ctx) == pytest.approx(5.0)
    peaks, count = bench.counts("peaks"), bench.counts("group_sweep")
    least = 4 * peaks.least_seconds(count.terms(2, 6, 256, 103, 10))[0]
    assert bench.reader("group_sweep_roofline_share").read(ctx) == pytest.approx(
        100.0 * least / 0.02)
    assert bench.reader("group_device_idle_share").read(ctx) == pytest.approx(75.0)
    ctx.trace = {"spans": {}}
    assert bench.reader("group_sweep_roofline_share").read(ctx) is None


def test_hemispheres_mirror_and_renumber():
    mesh = surface.hemispheres(2)
    left, right = mesh["left"], mesh["right"]
    v = len(left["coords"])
    assert not np.array_equal(left["edges"], right["edges"])
    assert {tuple(e) for e in np.sort(v - 1 - left["edges"], axis=1)} == {
        tuple(e) for e in right["edges"]}
    assert np.allclose(right["lengths"], surface.lengths_of(right["coords"], right["edges"]))
    assert np.array_equal(right["coords"][v - 1], left["coords"][0] * [-1, 1, 1])
    table = surface.neighbour_table(left["edges"], v)
    assert {(a, b) for a in range(v) for b in table[a, 1:] if b != a} == {
        (a, b) for e in left["edges"] for a, b in (e, e[::-1])}
