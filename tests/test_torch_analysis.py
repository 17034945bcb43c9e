"""Port parity: the analyses (calibration, simulation, noise ceilings).

The same seeded inputs go through the JAX package's function and the port's
(``device="cpu"``):

* ``t_threshold_monte_carlo``: the port draws the JAX package's normals from
  the same seed (``utils/threefry.py``), so its cutoffs agree within 1e-5
  relative (float32 t-values summed in another order) and the minimum
  accuracies above them are equal;
* the simulation's data are bit-equal, its ridge classifier's labels agree
  on >= 0.999 of the test samples, and ``train_and_eval``'s accuracies within
  1e-3;
* the noise ceilings and the t5 helpers are equal.
"""

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.analysis import calibration as JC
from multimodal_decoding_tpu.analysis import simulation as JS
from multimodal_decoding_tpu.analysis.noise_ceilings import noise_ceilings as j_noise_ceilings
from multimodal_decoding_tpu_torch.analysis import calibration as TC
from multimodal_decoding_tpu_torch.analysis import simulation as TS
from multimodal_decoding_tpu_torch.analysis.noise_ceilings import noise_ceilings

CUTOFF_RTOL = 1e-5
LABEL_AGREEMENT_MIN = 0.999
ACC_TOL = 1e-3
SMALL = dict(n_perms=200, n_subjects=6, n_latents=20, n_preds=3, dim=32,
             p_vals=(0.05, 0.005))


@pytest.mark.parametrize("seed", [0, 3])
def test_t_threshold_monte_carlo_matches_jax(seed):
    ref = JC.t_threshold_monte_carlo(**SMALL, seed=seed)
    got = TC.t_threshold_monte_carlo(**SMALL, seed=seed, device="cpu")
    assert list(got) == list(ref)
    for p, (cutoff, min_acc) in ref.items():
        assert got[p][0] == pytest.approx(cutoff, rel=CUTOFF_RTOL)
        np.testing.assert_array_equal(got[p][1], min_acc)  # NaN where none is above


def test_max_branch_at_one_over_n_perms():
    """p == 1 / n_perms takes the largest t, with nothing above it."""
    kw = dict(SMALL, p_vals=(1 / 200,))
    ref = JC.t_threshold_monte_carlo(**kw, seed=1)
    got = TC.t_threshold_monte_carlo(**kw, seed=1, device="cpu")
    assert got[1 / 200][0] == pytest.approx(ref[1 / 200][0], rel=CUTOFF_RTOL)
    assert np.isnan(got[1 / 200][1]) and np.isnan(ref[1 / 200][1])


def test_null_draws_do_not_depend_on_the_chunk(monkeypatch):
    args = (50, 6, 20, 3, 32, 7)
    monkeypatch.setattr(TC, "CHUNK", 7)
    a = TC.null_draws(*args, device="cpu")
    monkeypatch.setattr(TC, "CHUNK", 50)
    b = TC.null_draws(*args, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    accs, t, mean = a
    assert accs.shape == (50, 6) and t.shape == (50,) and mean.shape == (50,)
    assert accs.dtype == t.dtype == mean.dtype == np.float32


def test_mean_accuracy_rounds_like_jitted_jax():
    """jnp.mean of count / denom accuracies under jit: one fused multiply-add
    a subject; torch's mean differs in the last place on many rows."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    denom = 216
    counts = rng.randint(0, denom + 1, size=(4000, 6))
    recip = np.float32(1) / np.float32(denom)
    accs = counts.astype(np.float32) * recip
    ref = np.asarray(jax.jit(jax.vmap(lambda c: jnp.mean(c.astype(jnp.float32) / denom)))(
        jnp.asarray(counts)))
    np.testing.assert_array_equal(accs, np.asarray(jax.jit(lambda c: c.astype(jnp.float32)
                                                           / denom)(jnp.asarray(counts))))
    got = TC.mean_accuracy(torch.from_numpy(accs), denom).numpy()
    np.testing.assert_array_equal(got, ref)


def test_t5_helpers_equal_jax():
    ts = np.linspace(-6, 6, 25)
    np.testing.assert_array_equal(TC.t5_cdf(ts), JC.t5_cdf(ts))
    np.testing.assert_array_equal(TC.t5_min_of_two_cdf(ts), JC.t5_min_of_two_cdf(ts))
    for q in (0.5, 0.95, 0.999):
        assert TC.t5_quantile(q) == JC.t5_quantile(q)
        assert TC.t5_quantile(q, cdf=TC.t5_min_of_two_cdf) == \
            JC.t5_quantile(q, cdf=JC.t5_min_of_two_cdf)


@pytest.mark.parametrize("condition", JS.SECOND_MODALITY_CONDITIONS)
def test_condition_data_bit_equal(condition):
    ref = JS.generate_condition_data(condition, 3, 6, 5, 7, 24)
    got = TS.generate_condition_data(condition, 3, 6, 5, 7, 24)
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    assert TS._noise_scale(condition) == JS._noise_scale(condition)


def test_mod2_prototype_conditions(rng):
    """The JAX test's invariants, on the port's copy."""
    protos, indep = rng.rand(4, 8), rng.rand(4, 8)
    g = np.random.default_rng(0)
    for cond in TS.SECOND_MODALITY_CONDITIONS:
        assert TS._mod2_prototypes(protos, indep, cond, g).shape == protos.shape
    np.testing.assert_allclose(TS._mod2_prototypes(protos, indep, "inverse", g), -protos)
    half = TS._mod2_prototypes(protos, indep, "half_noise_half_same", g)
    np.testing.assert_allclose(half[:, 4:], protos[:, 4:])
    assert np.all(half[:, :4] == 0)
    ortho = TS._mod2_prototypes(protos, indep, "orthogonal", g)
    np.testing.assert_allclose(np.linalg.norm(ortho, axis=1), 1.0, atol=1e-9)
    with pytest.raises(RuntimeError, match="Unknown second modality"):
        TS._mod2_prototypes(protos, indep, "nonsense", g)


@pytest.mark.parametrize("condition", ["gauss_same_stddev", "orthogonal", "just_noise"])
def test_ridge_classifier_labels_match_jax(condition):
    (tr1, l1), (te1, _), (tr2, l2), (te2, _) = JS.generate_condition_data(
        condition, 0, 30, 40, 12, 200)
    tx, ty = np.concatenate([tr1, tr2]), np.concatenate([l1, l2])
    ref = JS.ridge_classifier_fit_predict(tx, ty, [te1, te2], 1.0, 12)
    got = TS.ridge_classifier_fit_predict(tx, ty, [te1, te2], 1.0, 12, device="cpu")
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.int64
        assert np.mean(g == r) >= LABEL_AGREEMENT_MIN


def test_ridge_classifier_constant_feature_and_sklearn(rng):
    """A constant feature scales by 1 (sklearn); the JAX test's sklearn check."""
    from sklearn.linear_model import RidgeClassifier
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    n, f, c = 120, 12, 5
    protos = rng.randn(c, f) * 2
    labels = rng.randint(0, c, size=n)
    X = (protos[labels] + rng.randn(n, f)).astype(np.float32)
    X[:, 3] = 2.5
    Xq = (protos[rng.randint(0, c, 40)] + rng.randn(40, f)).astype(np.float32)
    got = TS.ridge_classifier_fit_predict(X, labels, [Xq], alpha=1.0, n_classes=c,
                                          device="cpu")[0]
    ref = JS.ridge_classifier_fit_predict(X, labels, [Xq], alpha=1.0, n_classes=c)[0]
    assert np.mean(got == ref) >= LABEL_AGREEMENT_MIN
    sk = make_pipeline(StandardScaler(), RidgeClassifier(alpha=1.0)).fit(X, labels)
    assert np.mean(got == sk.predict(Xq)) > 0.95


@pytest.mark.parametrize("condition", ["gauss_same_stddev", "just_noise"])
def test_train_and_eval_matches_jax(condition):
    """The JAX test's sizes (8 classes, 20 samples a class, 200 voxels)."""
    kw = dict(alpha=1.0, n_seeds=2, n_train_per_class=20, n_test_per_class=20,
              n_classes=8, n_voxels=200)
    ref = JS.train_and_eval(condition, **kw)
    got = TS.train_and_eval(condition, **kw, device="cpu")
    assert [{k: r[k] for k in ("condition", "modality", "decoder_type")} for r in got] == \
        [{k: r[k] for k in ("condition", "modality", "decoder_type")} for r in ref]
    np.testing.assert_allclose([r["acc"] for r in got], [r["acc"] for r in ref],
                               rtol=0, atol=ACC_TOL)
    accs = {(r["decoder_type"], r["modality"]): r["acc"] for r in got}
    if condition == "gauss_same_stddev":
        assert accs[("modality_agnostic", "avg")] > 0.4  # well above chance (1/8)
    else:
        assert accs[("modality_specific_mod2", "mod2")] < 0.3  # mod2 carries no signal


def test_run_all_conditions_passes_device(monkeypatch):
    seen = []
    monkeypatch.setattr(TS, "train_and_eval",
                        lambda cond, alpha, n_seeds, device=None, **kw: seen.append(
                            (cond, n_seeds, device, kw)) or [])
    assert TS.run_all_conditions(n_seeds=2, device="cpu", n_classes=4) == []
    assert [s[0] for s in seen] == TS.SECOND_MODALITY_CONDITIONS
    assert all(s[1:] == (2, "cpu", {"n_classes": 4}) for s in seen)


def test_noise_ceilings_equal_jax(rng):
    base = rng.randn(20, 15)
    betas = {f"sub-0{i}": base + 0.3 * rng.randn(20, 15) for i in range(1, 5)}
    got = noise_ceilings(betas)
    assert got == j_noise_ceilings(betas)
    for lower, upper in got.values():
        assert -1 <= lower <= upper <= 1 and upper > 0.5
    assert noise_ceilings(betas, "pearsonr", "pearsonr") == \
        j_noise_ceilings(betas, "pearsonr", "pearsonr")


def test_device_entry_points_raise_without_a_gpu(monkeypatch):
    from multimodal_decoding_tpu_torch.ops import metrics as TM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 4), np.float32)
    for call in (lambda: TC.t_threshold_monte_carlo(**SMALL),
                 lambda: TC.null_draws(10, 2, 4, 2, 8),
                 lambda: TS.ridge_classifier_fit_predict(x, np.arange(8) % 2, [x], 1.0, 2),
                 lambda: TS.train_and_eval("just_noise", n_seeds=1, n_classes=2,
                                           n_train_per_class=2, n_test_per_class=2,
                                           n_voxels=4),
                 lambda: TS.run_all_conditions(n_seeds=1),
                 lambda: TM.get_distance_matrix_csls(x, x, knn=3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
