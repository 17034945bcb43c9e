"""Each cell's driver, the program and the plain reference at a tiny size on
the CPU: a sound run comes out correct, and each fault the cell can have,
planted under the timed path, comes out not correct.

The faults, as the benchmark's contract names them: a step that returns its
state unchanged (the block step or the decode hands back its first answer
again), half of the batch left out with the mean taken over the rest (the
train rows of a searchlight block; the features of a gram), and an answer
altered where it is produced.  A cell on one chip has no exchange between
chips to leave out.  Each driver module names in ``FAULTS`` the program
functions each fault wraps and the helper that plants it (its own, or one of
``portbench/tests/faults.py``), and may name more faults of its own;
``FAULT_NUMBERS`` names a number such a fault has to fail.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from portbench.harness import bench, judge
from portbench.tests.tiny import CELLS, run_tiny, tiny_cell

import multimodal_decoding_tpu_torch.parallel.searchlight_runner as SR  # noqa: E402


def correct(name: str, numbers: dict) -> bool:
    return judge.verdict(numbers, tiny_cell(name)[1]["limits"])[0]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    drv, record, numbers = run_tiny(name)
    attempted, failed = drv.attempted_failed()
    assert attempted > 0 and failed == 0
    assert record["window_s"] >= 0.3
    assert correct(name, numbers), numbers
    mask = getattr(drv, "mask", None)
    if mask is not None:  # a padded adjacency: the tiny cell really masks columns
        counts = mask.sum(axis=1)
        assert counts.max() == mask.shape[1] and counts.mean() < counts.max()


@pytest.mark.parametrize("name", [c for c in CELLS if "block_size" in tiny_cell(c)[0]])
def test_runner_chooses_the_block_size(name):
    """``block_size`` None, as the CLI passes it: the driver takes the runner's
    block size from the warm-up call and runs whole blocks of it, the block
    the runner picks for the driver's own adjacency width."""
    config, traffic, kind = tiny_cell(name)
    drv = bench.module("drivers", kind).Driver(dict(config, block_size=None), traffic, 7, "cpu")
    drv.setup()
    record = drv.window(0.1)
    drv.release()
    assert record["block_size"] == drv.B == SR._auto_block_size(
        config["n_train"] + config["n_test"] + config["n_imagery"], drv.adjacency.shape[1])
    assert correct(name, drv.check())


CELL_FAULTS = [(c, f) for c in CELLS for f in bench.module("drivers", tiny_cell(c)[2]).FAULTS]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    drv = bench.module("drivers", tiny_cell(name)[2])
    for module, attr, plant in drv.FAULTS[fault]:
        module = importlib.import_module(module)
        monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    # two windows: a stale answer shows only beside a call that differs from the first
    _, _, numbers = run_tiny(name, windows=2)
    assert not correct(name, numbers), numbers
    number = getattr(drv, "FAULT_NUMBERS", {}).get(fault)
    if number:
        assert numbers[number] > tiny_cell(name)[1]["limits"][number], numbers


def test_every_cell_can_have_the_contracts_faults():
    for c in CELLS:
        faults = bench.module("drivers", tiny_cell(c)[2]).FAULTS
        assert {"state_unchanged", "half_batch", "answer_altered"} <= set(faults), c


def test_same_seed_same_inputs():
    a, _, _ = run_tiny("sl-cv-null", seed=5, seconds=0.0)
    b, _, _ = run_tiny("sl-cv-null", seed=5, seconds=0.0)
    c, _, _ = run_tiny("sl-cv-null", seed=6, seconds=0.0)
    assert torch.equal(a.X_all, b.X_all) and np.array_equal(a.shuffles, b.shuffles)
    assert not torch.equal(a.X_all, c.X_all)


def test_large_seed():
    drv, _, numbers = run_tiny("wb-sweep", seed=2 ** 31 + 12345, seconds=0.0)
    assert drv.attempted_failed()[0] > 0 and correct("wb-sweep", numbers)
