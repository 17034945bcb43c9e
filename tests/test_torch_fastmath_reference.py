"""The port's ``--fast-math`` fixed-alpha searchlight against the plain
reference of its 16-bit contract (``portbench/reference/searchlight_fastmath.py``).

On seeded random data at a small size (``icosphere(2)``, K 12, N 60, D 16,
5 null shuffles), on the CPU: the block step's predictions through gather,
fit and solve, and the whole step's scores and nulls through
``run_searchlight`` with the arguments ``--fast-math`` maps to, held to the
reference's.  The control, the reference one precision below the contract
(each bf16 product's output rounded to bf16 too), put in the program's
place, fails a number by 10x or more.  ``precision_arguments`` returns what
``decoding/searchlight.run`` passed to the runner before it existed.

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
from multimodal_decoding_tpu_torch.decoding.searchlight import precision_arguments
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight
from portbench.harness import data, judge
from portbench.reference import plain
from portbench.reference import searchlight_fastmath as FM

N_TRAIN, N_TEST, N_IMAG, D, K, N_PERMS, BLOCK = 60, 20, 3, 16, 12, 5, 16
ALPHA = 1.0
SEEDS = (0, 1, 2)

# Both sides sum the same exact products of bf16 operands in float32, in
# another order at most: N * 2^-24 = 3.6e-6 of the terms' magnitudes, through
# the solve's condition number (G + I over 60 rows of 12 columns, under 30).
# Rounding the predictions alone to bf16, as the control does, moves them by
# up to 2^-9 = 2.0e-3 of themselves.
PRED_GAP_MAX = 1e-4
# No comparison may come out otherwise: one of the ~82,000 the scores and
# nulls count at this size reads 1.2e-5.  The port's accuracies are float32
# counts times 1 / comparisons, the reference's float64: they differ by
# ~1.6e-8 with no comparison flipped.
FLIPS_MAX = 1e-6
CONTROL_FACTOR = 10


def _inputs(seed):
    coords = data.icosphere_coords(2)
    adjacency = data.knn_on_device(coords, K, "cpu")
    gen = data.generator(seed, "cpu")
    X, Y = data.planted_searchlight(gen, coords, N_TRAIN, N_TEST, N_IMAG, D, (-1.5, 0.0),
                                    "cpu")
    shuffles = data.within_modality_shuffles(data.rng(seed, data.STREAM_SHUFFLES), N_PERMS,
                                             N_TEST)
    n_padded = -(-len(coords) // BLOCK) * BLOCK
    der = data.rng(seed, data.STREAM_DERANGEMENTS).integers(0, 2, (n_padded, N_PERMS))
    return X, Y, adjacency, shuffles, der


def _stim_types():
    return np.array(["caption"] * (N_TEST // 2) + ["image"] * (N_TEST - N_TEST // 2))


def _program_predictions(X, Y_train, idx):
    """The block step's test predictions [B, n_test, D]: gather, fit, solve, predict."""
    args = precision_arguments(True)
    patches = E.gather_patches(X.to(args["dtype"]), idx)
    W = E.fit_block(patches[:N_TRAIN], Y_train, ALPHA, precision=args["precision"])
    return E.predict_block(patches[N_TRAIN:N_TRAIN + N_TEST], W, args["precision"])


def _reference_predictions(X, Y_train, idx):
    """The contract's test predictions, with the reference's own pieces."""
    patches = X.as_subclass(FM.Betas)[:, idx].permute(1, 0, 2)
    Xtr, Xte = patches[:, :N_TRAIN], patches[:, N_TRAIN:N_TRAIN + N_TEST]
    W = plain.ridge_solve(Xtr.transpose(1, 2) @ Xtr, Xtr.transpose(1, 2) @ Y_train, ALPHA)
    return Xte @ W


def _pred_gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _program_answers(X, Y, adjacency, shuffles, der):
    scores, aux = run_searchlight(
        None, None, None, *(y.numpy() for y in Y), adjacency, _stim_types(), alpha=ALPHA,
        shuffles=shuffles, imagery_derangements=der, block_size=BLOCK, device="cpu",
        progress=False, x_all_device=X.to(precision_arguments(True)["dtype"]),
        n_rows_split=(N_TRAIN, N_TEST, N_IMAG), **precision_arguments(True))
    return {"alpha": None, "scores": scores, "null": aux["null_scores"]}


def _reference_answers(X, Y, adjacency, shuffles, der):
    rows = torch.arange(N_TEST)
    return FM.vertices(X, torch.as_tensor(adjacency), *Y, rows[:N_TEST // 2],
                       rows[N_TEST // 2:], torch.as_tensor(shuffles).long(),
                       torch.as_tensor(der[:len(adjacency)]), alpha=ALPHA)


def _flips(got, ref):
    return judge.searchlight(got, dict(ref, alphas=None), plain.comparisons(N_TEST, N_IMAG))


@pytest.mark.parametrize("seed", SEEDS)
def test_block_predictions_match_the_reference(seed):
    X, Y, adjacency, *_ = _inputs(seed)
    idx = torch.as_tensor(adjacency[:BLOCK]).long()
    gap = _pred_gap(_program_predictions(X, Y[0], idx), _reference_predictions(X, Y[0], idx))
    assert gap <= PRED_GAP_MAX, gap


@pytest.mark.parametrize("seed", SEEDS)
def test_scores_and_nulls_match_the_reference(seed):
    inputs = _inputs(seed)
    numbers = _flips(_program_answers(*inputs), _reference_answers(*inputs))
    assert numbers["score_flips"] <= FLIPS_MAX and numbers["null_flips"] <= FLIPS_MAX, numbers


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_by_ten_times(seed):
    """The reference one precision below the contract, in the program's place."""
    X, Y, adjacency, shuffles, der = _inputs(seed)
    idx = torch.as_tensor(adjacency[:BLOCK]).long()
    ref_pred = _reference_predictions(X, Y[0], idx)
    ref = _reference_answers(X, Y, adjacency, shuffles, der)
    with FM.OutputsInBf16():
        gap = _pred_gap(_reference_predictions(X, Y[0], idx), ref_pred)
        numbers = _flips(_reference_answers(X, Y, adjacency, shuffles, der), ref)
    assert FM.Betas.product is FM.bf16_pass  # restored on exit
    assert max(gap / PRED_GAP_MAX, numbers["score_flips"] / FLIPS_MAX,
               numbers["null_flips"] / FLIPS_MAX) >= CONTROL_FACTOR, (gap, numbers)


def test_the_reference_rounds_its_betas():
    """Betas given in float32 or already in bf16 give the same answers."""
    X, Y, adjacency, shuffles, der = _inputs(0)
    a = _reference_answers(X, Y, adjacency, shuffles, der)
    b = _reference_answers(X.to(torch.bfloat16), Y, adjacency, shuffles, der)
    for key in ("scores", "null"):
        for m in a[key]:
            np.testing.assert_array_equal(a[key][m], b[key][m])


# What decoding/searchlight.run passed to run_searchlight before the mapping
# was one function, written out for each flag (the CPU's CV solver, schur-cb).
BEFORE = {
    (True, True, False): dict(dtype=torch.bfloat16, precision="default", cv_precision=None,
                              cv_solver=None, cv_scorer="xla", cv_dtype=None),
    (True, True, True): dict(dtype=torch.bfloat16, precision="default", cv_precision="highest",
                             cv_solver="schur-cb", cv_scorer="xla", cv_dtype=None),
    (True, False, True): dict(dtype=torch.bfloat16, precision="default", cv_precision=None,
                              cv_solver=None, cv_scorer="strict", cv_dtype=None),
    (False, True, False): dict(dtype=torch.float32, precision="highest", cv_precision=None,
                               cv_solver=None, cv_scorer="xla", cv_dtype=None),
    (False, True, True): dict(dtype=torch.float32, precision="highest", cv_precision="highest",
                              cv_solver="schur-cb", cv_scorer="xla", cv_dtype=None),
    (False, False, True): dict(dtype=torch.float32, precision="highest", cv_precision=None,
                               cv_solver=None, cv_scorer="strict", cv_dtype=None),
}


@pytest.mark.parametrize("flags", sorted(BEFORE),
                         ids=lambda f: "fast_math={}-fast_cv={}-cv={}".format(*f))
def test_precision_arguments_are_what_run_passed(flags):
    fast_math, fast_cv, cv = flags
    got = precision_arguments(fast_math, fast_cv, [1.0, 10.0] if cv else None,
                              torch.device("cpu"))
    assert got == BEFORE[flags]
