"""Each cell's driver, the program and the plain reference at a tiny size on
the CPU: a sound run comes out correct, and each fault the cell can have,
planted under the timed path, comes out not correct.

The faults, as the benchmark's contract names them: a step that returns its
state unchanged (the block step or the decode hands back its first answer
again), half of the batch left out with the mean taken over the rest (the
train rows of a searchlight block; the features of a gram), and an answer
altered where it is produced.  A cell on one chip has no exchange between
chips to leave out.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.harness import bench, judge
from portbench.tests.tiny import CELLS, run_tiny, tiny_cell

import multimodal_decoding_tpu_torch.decoding.whole_brain as WB  # noqa: E402
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


@pytest.mark.parametrize("name", [c for c in CELLS if tiny_cell(c)[2] == "searchlight"])
def test_runner_chooses_the_block_size(name):
    """``block_size`` None, as the CLI passes it: the driver takes the runner's
    block size from the warm-up call and runs whole blocks of it."""
    config, traffic, kind = tiny_cell(name)
    drv = bench.module("drivers", kind).Driver(dict(config, block_size=None), traffic, 7, "cpu")
    drv.setup()
    record = drv.window(0.1)
    drv.release()
    assert record["block_size"] == drv.B == SR._auto_block_size(
        config["n_train"] + config["n_test"] + config["n_imagery"], config["n_neighbors"])
    assert correct(name, drv.check())


def _stale(fn):
    first = []

    def step(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return step


def _half_rows(fn):
    """A searchlight block step fitted on the first half of its train rows,
    their products doubled (the mean over the rest)."""
    def step(X_all, Y_train, *a, n_train, **k):
        h = n_train // 2
        X, Y = X_all.clone(), Y_train.clone()
        X[:h] *= math.sqrt(2.0)
        X[h:n_train] = 0.0
        Y[:h] *= math.sqrt(2.0)
        Y[h:] = 0.0
        return fn(X, Y, *a, n_train=n_train, **k)
    return step


def _altered_vertex(fn):
    def step(*a, **k):
        main, null = fn(*a, **k)
        main = dict(main)
        main["pairwise_acc_captions"] = main["pairwise_acc_captions"].clone()
        main["pairwise_acc_captions"][0] += 0.25
        return main, null
    return step


def _half_features(fn):
    def kernels(X_train, queries=(), *a, **k):
        h = X_train.shape[1] // 2
        K, Kq = fn(X_train[:, :h], tuple(q[:, :h] for q in queries), *a, **k)
        return 2.0 * K, [2.0 * q for q in Kq]
    return kernels


def _altered_prediction(fn):
    def decode(*a, **k):
        alpha, test_preds, imag_preds, cv, fit_s = fn(*a, **k)
        test_preds = test_preds.copy()
        test_preds[0] += 1.0
        return alpha, test_preds, imag_preds, cv, fit_s
    return decode


SEARCHLIGHT_STEPS = ("searchlight_block_cv_with_null", "searchlight_block_with_null")
FAULTS = {
    "searchlight": {
        "state_unchanged": [(SR, s, _stale) for s in SEARCHLIGHT_STEPS],
        "half_batch": [(SR, s, _half_rows) for s in SEARCHLIGHT_STEPS],
        "answer_altered": [(SR, s, _altered_vertex) for s in SEARCHLIGHT_STEPS],
    },
    "whole_brain": {
        "state_unchanged": [(WB, "decode_single", _stale)],
        "half_batch": [(WB, "streamed_kernels", _half_features)],
        "answer_altered": [(WB, "decode_single", _altered_prediction)],
    },
}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    kind = tiny_cell(name)[2]
    for module, attr, plant in FAULTS[kind][fault]:
        monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    _, _, numbers = run_tiny(name)
    assert not correct(name, numbers), numbers


def test_same_seed_same_inputs():
    a, _, _ = run_tiny("sl-cv-null", seed=5, seconds=0.0)
    b, _, _ = run_tiny("sl-cv-null", seed=5, seconds=0.0)
    c, _, _ = run_tiny("sl-cv-null", seed=6, seconds=0.0)
    assert torch.equal(a.X_all, b.X_all) and np.array_equal(a.shuffles, b.shuffles)
    assert not torch.equal(a.X_all, c.X_all)


def test_large_seed():
    drv, _, numbers = run_tiny("wb-sweep", seed=2 ** 31 + 12345, seconds=0.0)
    assert drv.attempted_failed()[0] > 0 and correct("wb-sweep", numbers)
