"""Port parity: metric primitives and CV-selection helpers vs the JAX package.

Float outputs agree within 1e-6; accuracies are equal.  The JAX functions are
called under ``jax.jit``, as the JAX block steps run them: XLA then divides
counts by a constant through its float32 reciprocal, and the port rounds the
same way (``metrics.count_ratio``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import metrics as JM
from multimodal_decoding_tpu.ops import ridge as JR
from multimodal_decoding_tpu_torch.ops import metrics as TM
from multimodal_decoding_tpu_torch.ops import ridge as TR

FLOAT_TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_metric_name_constants_match():
    """The metric vocabulary (constants defined in metrics.py, not imported)."""
    from multimodal_decoding_tpu import config as jax_config
    from multimodal_decoding_tpu_torch import config as torch_config

    own = [n for n in dir(JM) if n.isupper() and not hasattr(jax_config, n)]
    assert "ACC_CAPTIONS" in own and "CHANCE_VALUES" in own
    for n in own:
        assert getattr(TM, n) == getattr(JM, n), n
    assert {n for n in dir(TM) if n.isupper() and not hasattr(torch_config, n)} == set(own)


def test_standardize_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 7, 5).astype(np.float32)
    x[..., 2] = 0.0  # zero-variance column: scale 1, sklearn semantics
    ref = np.asarray(jax.jit(JM.standardize)(x))
    got = TM.standardize(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=FLOAT_TOL)
    np.testing.assert_array_equal(got[..., 2], 0.0)


def test_standardize_constant_column_is_zero():
    """sklearn maps any constant column to 0.  Under jit the JAX version maps
    a constant 3.0 over 7 rows to +-1 instead: its mean, a sum times the
    float32 reciprocal of 7, misses 3.0 by one ulp, so the std is ~1e-7, not
    0 (recorded in ROADMAP section C)."""
    x = np.full((1, 7, 2), 3.0, dtype=np.float32)
    np.testing.assert_array_equal(TM.standardize(_t(x)).numpy(), 0.0)
    assert np.all(np.abs(np.asarray(jax.jit(JM.standardize)(x))) == 1.0)


def test_cosine_distances_match_jax():
    rng = np.random.RandomState(1)
    p = rng.randn(3, 6, 9).astype(np.float32)
    l = rng.randn(8, 9).astype(np.float32)
    ref = np.asarray(jax.jit(JM.cosine_distances)(p, l))
    np.testing.assert_allclose(TM.cosine_distances(_t(p), _t(l)).numpy(), ref,
                               rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("shape", [(5, 5), (4, 3, 3), (2, 3, 143)])
def test_pairwise_acc_from_dist_matches_jax(shape):
    """Square, batched and the imagery-vs-whole-test [3, 143] layout."""
    dist = np.random.RandomState(2).rand(*shape).astype(np.float32)
    ref = np.asarray(jax.jit(JM.pairwise_acc_from_dist)(dist))
    got = TM.pairwise_acc_from_dist(_t(dist)).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_pairwise_acc_from_sim_matches_jax():
    sim = np.random.RandomState(3).randn(6, 7, 7).astype(np.float32)
    ref = np.asarray(jax.jit(JM.pairwise_acc_from_sim)(sim))
    np.testing.assert_array_equal(TM.pairwise_acc_from_sim(_t(sim)).numpy(), ref)


def test_pairwise_acc_scale_invariant_matches_jax_and_cosine():
    rng = np.random.RandomState(4)
    preds = rng.randn(5, 9, 6).astype(np.float32) * rng.rand(5, 9, 1).astype(np.float32) * 10
    lat = rng.randn(9, 6).astype(np.float32)
    lat_n = lat / np.linalg.norm(lat, axis=-1, keepdims=True)
    # tie-free inputs: every compared cosine gap exceeds 1e-4
    p64 = preds / np.linalg.norm(preds, axis=-1, keepdims=True)
    sim64 = p64.astype(np.float64) @ lat_n.T.astype(np.float64)
    gaps = np.abs(sim64 - np.diagonal(sim64, axis1=-2, axis2=-1)[..., :, None])
    gaps[..., np.arange(9), np.arange(9)] = np.inf
    assert gaps.min() > 1e-4
    ref = np.asarray(jax.jit(JM.pairwise_acc_scale_invariant)(preds, lat_n))
    got = TM.pairwise_acc_scale_invariant(_t(preds), _t(lat_n)).numpy()
    np.testing.assert_array_equal(got, ref)
    strict = TM.pairwise_acc_from_dist(TM.cosine_distances(_t(preds), _t(lat))).numpy()
    np.testing.assert_array_equal(got, strict)


@pytest.mark.parametrize("denom", [20, 6, 426, 2 * 1638 * 1637 // 2, 4830])
def test_count_ratio_rounds_like_jitted_jax(denom):
    counts = np.arange(0, min(denom, 5000) + 1, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda c: c / denom)(counts))
    got = TM.count_ratio(_t(counts), denom).numpy()
    np.testing.assert_array_equal(got, ref)


def test_first_argmax_with_tol_matches_jax():
    s = np.array([
        [0.5, 0.5, 0.7, 0.7 - 5e-7, 0.2],       # exact tie, sub-tol tie
        [0.1, 0.6, 0.6, 0.6 + 5e-7, 0.3],       # later index wins by < tol
        [0.9, 0.5, 0.7, 0.7 + 2e-6, 0.8],       # genuine win beyond tol
    ], dtype=np.float32).T  # [A, B]
    ref = np.asarray(JR.first_argmax_with_tol(jnp.asarray(s), axis=0))
    got = TR.first_argmax_with_tol(_t(s), axis=0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert TR.ALPHA_TIE_TOL == JR.ALPHA_TIE_TOL


@pytest.mark.parametrize("n,k", [(40, 5), (8192, 5), (33, 4), (7, 7)])
def test_kfold_indices_match_jax(n, k):
    for (tr_t, va_t), (tr_j, va_j) in zip(TR.kfold_indices(n, k), JR.kfold_indices(n, k)):
        np.testing.assert_array_equal(tr_t, tr_j)
        np.testing.assert_array_equal(va_t, va_j)
