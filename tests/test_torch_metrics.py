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


# ---------------------------------------------------------------------------
# The whole-brain score family
# ---------------------------------------------------------------------------


def _min_cosine_gap(preds, latents) -> float:
    """Smallest float64 gap between a row's diagonal and off-diagonal cosine
    distances: the inputs are tie-free when it is well above float32 noise."""
    p = preds / np.linalg.norm(preds, axis=-1, keepdims=True)
    l = latents / np.linalg.norm(latents, axis=-1, keepdims=True)
    d = 1.0 - p.astype(np.float64) @ l.T.astype(np.float64)
    k = min(d.shape)
    gaps = np.abs(d[:k] - np.diagonal(d)[:, None])
    gaps[np.arange(k), np.arange(k)] = np.inf
    return float(gaps.min())


def _score_inputs(seed: int = 7, n: int = 24, d: int = 16, n_imag: int = 3):
    rng = np.random.RandomState(seed)
    latents = rng.randn(n, d).astype(np.float32)
    preds = (latents + 1.5 * rng.randn(n, d)).astype(np.float32) * 3.0 + 0.5
    imag_latents = rng.randn(n_imag, d).astype(np.float32)
    imag_preds = (imag_latents + rng.randn(n_imag, d)).astype(np.float32)
    stim_types = np.array(["caption", "image"] * (n // 2))[rng.permutation(n)]
    return latents, preds, imag_latents, imag_preds, stim_types


def test_fit_standardizer_matches_jax():
    x = np.random.RandomState(5).randn(2, 9, 4).astype(np.float32)
    x[..., 1] = 0.0
    ref_m, ref_s = jax.jit(JM.fit_standardizer)(x)
    got_m, got_s = TM.fit_standardizer(_t(x))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=0, atol=FLOAT_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=FLOAT_TOL)
    np.testing.assert_array_equal(got_s.numpy()[..., 1], 1.0)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_distance_matrix_matches_jax(metric):
    rng = np.random.RandomState(6)
    p = rng.randn(2, 5, 7).astype(np.float32)
    l = rng.randn(6, 7).astype(np.float32)
    ref = np.asarray(JM.get_distance_matrix(p, l, metric))
    got = TM.get_distance_matrix(p, l, metric, device="cpu")
    assert got.shape == ref.shape
    # euclidean distances are ~4 here: 1e-6 relative
    np.testing.assert_allclose(got.numpy(), ref, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    with pytest.raises(ValueError, match="unsupported distance metric"):
        TM.get_distance_matrix(p, l, "cityblock", device="cpu")


@pytest.mark.parametrize("std_preds,std_lat", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_pairwise_accuracy_matches_jitted_jax(metric, std_preds, std_lat):
    latents, preds, *_ = _score_inputs()
    assert _min_cosine_gap(preds, latents) > 1e-4
    ref = np.asarray(jax.jit(lambda l, p: JM.pairwise_accuracy(
        l, p, std_preds, std_lat, metric))(latents, preds))
    got = TM.pairwise_accuracy(latents, preds, std_preds, std_lat, metric, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("norm_imagery", [False, True])
@pytest.mark.parametrize("std_preds", [False, True])
@pytest.mark.parametrize("imagery", [False, True])
def test_calc_all_pairwise_accuracy_scores_match_jitted_jax(imagery, std_preds, norm_imagery):
    """Bit-equal on tie-free inputs, captions and images interleaved."""
    latents, preds, imag_l, imag_p, stim_types = _score_inputs()
    kwargs = dict(standardize_predictions=std_preds,
                  norm_imagery_preds_with_test_preds=norm_imagery)

    def jax_scores(l, p, il, ip):
        return JM.calc_all_pairwise_accuracy_scores(
            l, p, stim_types, il if imagery else None, ip if imagery else None, **kwargs)

    ref = jax.jit(jax_scores)(latents, preds, imag_l, imag_p)
    got = TM.calc_all_pairwise_accuracy_scores(
        latents, preds, stim_types, imag_l if imagery else None,
        imag_p if imagery else None, device="cpu", **kwargs)
    assert set(got) == set(ref)
    assert (TM.ACC_IMAGERY in got) == imagery
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)


def test_calc_all_scores_take_tensors_on_their_device():
    """Tensors stay where they are; arrays go to ``device`` (cuda unless
    named, so without a GPU they need device="cpu")."""
    latents, preds, imag_l, imag_p, stim_types = _score_inputs()
    got = TM.calc_all_pairwise_accuracy_scores(_t(latents), _t(preds), stim_types,
                                               _t(imag_l), _t(imag_p))
    ref = TM.calc_all_pairwise_accuracy_scores(latents, preds, stim_types, imag_l, imag_p,
                                               device="cpu")
    assert all(got[k].device.type == "cpu" and torch.equal(got[k], ref[k]) for k in ref)


def test_eager_jax_scores_round_counts_by_true_division():
    """The JAX whole-brain decoder scores eagerly, where counts / n is a true
    division; under jit (the JAX block steps, and the port's count_ratio)
    it is a product with the float32 reciprocal.  They differ by at most one
    ulp (recorded in ROADMAP section C)."""
    latents, preds, imag_l, imag_p, stim_types = _score_inputs()
    eager = JM.calc_all_pairwise_accuracy_scores(latents, preds, stim_types, imag_l, imag_p)
    got = TM.calc_all_pairwise_accuracy_scores(latents, preds, stim_types, imag_l, imag_p,
                                               device="cpu")
    for name in eager:
        e, g = np.float32(eager[name]), got[name].numpy()
        assert abs(g - e) <= np.spacing(e), name


# ---------------------------------------------------------------------------
# RSA (host copies) and CSLS (torch)
# ---------------------------------------------------------------------------

CSLS_TOL = 1e-6


@pytest.mark.parametrize("metric,matrix_metric", [("spearmanr", "spearmanr"),
                                                  ("pearsonr", "pearsonr"),
                                                  ("spearmanr", "pearsonr")])
def test_rsa_helpers_equal_jax(metric, matrix_metric):
    rng = np.random.RandomState(7)
    a, b = rng.randn(12, 9), rng.randn(12, 9)
    b[:, 0] = a[:, 0]  # some shared structure
    a[3] = a[4]  # tied ranks
    np.testing.assert_array_equal(TM.create_dissimilarity_matrix(a, matrix_metric),
                                  JM.create_dissimilarity_matrix(a, matrix_metric))
    assert TM.calc_rsa(a, b, metric, matrix_metric) == JM.calc_rsa(a, b, metric, matrix_metric)
    m1, m2 = rng.rand(30), rng.rand(30)
    assert TM.rsa_from_matrices(m1, m2, metric) == JM.rsa_from_matrices(m1, m2, metric)
    types = np.array(["caption", "image"] * 6)
    assert TM.calc_rsa_images(a, b, types, metric, matrix_metric) == \
        JM.calc_rsa_images(a, b, types, metric, matrix_metric)
    assert TM.calc_rsa_captions(a, b, types, metric, matrix_metric) == \
        JM.calc_rsa_captions(a, b, types, metric, matrix_metric)


def test_rsa_unknown_metric_raises():
    with pytest.raises(RuntimeError, match="Unknown metric"):
        TM.create_dissimilarity_matrix(np.eye(3), "kendall")
    with pytest.raises(RuntimeError, match="Unknown metric"):
        TM.rsa_from_matrices(np.ones(3), np.ones(3), "kendall")


@pytest.mark.parametrize("shapes,knn", [(((14, 32), (14, 32)), 5),
                                        (((14, 32), (9, 32)), 100),  # knn > both sets
                                        (((3, 10, 16), (3, 12, 16)), 4),
                                        (((2, 3, 10, 16), (12, 16)), 7)],
                         ids=["square", "knn_larger", "batched", "broadcast_latents"])
def test_csls_matches_jax(shapes, knn):
    rng = np.random.RandomState(11)
    p = rng.randn(*shapes[0]).astype(np.float32)
    l = rng.randn(*shapes[1]).astype(np.float32)
    ref = np.asarray(jax.jit(JM.get_distance_matrix_csls, static_argnums=2)(p, l, knn))
    got = TM.get_distance_matrix_csls(p, l, knn, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=CSLS_TOL)
    # tensors stay on their device
    assert TM.get_distance_matrix_csls(_t(p), _t(l), knn).device.type == "cpu"
