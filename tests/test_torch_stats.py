"""Port parity: group statistics (``ops/stats.py``) against the JAX package.

Seeded numpy inputs go through the JAX function and the port's torch one
(``device="cpu"``).  t-maps agree within 1e-5 with equal NaN patterns
(degenerate vertices, NaN scores, ``sigma > 0``); the numpy helpers are
copies and agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import stats as JS
from multimodal_decoding_tpu_torch.ops import stats as TS

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, equal_nan=True, **TOL)


def _scores(rng, shape, n_nan=3, n_degenerate=3):
    """Accuracy-like float32 scores over the last axis (vertices) with NaN
    vertices and degenerate ones (every subject equal)."""
    x = (0.5 + 0.08 * rng.randn(*shape)).astype(np.float32)
    v = shape[-1]
    cols = rng.choice(v, n_nan + n_degenerate, replace=False)
    x[..., cols[:n_nan]] = np.nan
    x[..., cols[n_nan:]] = x[:1, ..., cols[n_nan:]]  # subject 0's value everywhere
    return x


def test_metric_tables_are_copies():
    assert TS.T_VAL_METRICS == JS.T_VAL_METRICS
    assert TS.COMPOSITE_METRICS == JS.COMPOSITE_METRICS


@pytest.mark.parametrize("sigma", [0.0, 1e-3, 0.1])
@pytest.mark.parametrize("n_subjects", [3, 6])
def test_t_map_matches_jax(sigma, n_subjects):
    rng = np.random.RandomState(n_subjects)
    x = _scores(rng, (n_subjects, 200))
    x[:, 7] = 0.7  # all subjects identical
    x[2, 11] = np.nan  # one subject's NaN
    ref = np.asarray(JS.t_map(jnp.asarray(x), 0.5, sigma=sigma))
    got = TS.t_map(x, 0.5, sigma=sigma, device="cpu")
    assert got.dtype == torch.float32
    _close(got, ref)
    assert torch.isnan(got[7]) and torch.isnan(got[11])
    if sigma == 0.0:  # the t-test itself, without the guard
        _close(TS.ttest_1samp_no_p(x[:, :5] - 0.5, device="cpu"),
               JS.ttest_1samp_no_p(jnp.asarray(x[:, :5] - 0.5)))


def test_ttest_absolute_sigma_matches_jax():
    x = np.random.RandomState(1).randn(5, 40).astype(np.float32)
    _close(TS.ttest_1samp_no_p(x, sigma=0.5, method="absolute", device="cpu"),
           JS.ttest_1samp_no_p(jnp.asarray(x), sigma=0.5, method="absolute"))


def test_composite_t_maps_match_jax():
    rng = np.random.RandomState(2)
    t_values = {m: rng.randn(30).astype(np.float32) for m in JS.T_VAL_METRICS}
    t_values[JS.T_VAL_METRICS[0]][2] = np.nan
    for members in JS.COMPOSITE_METRICS.values():  # a vertex where every member is NaN
        for m in members:
            t_values[m][5] = np.nan
    ref = JS.composite_t_maps({k: jnp.asarray(v) for k, v in t_values.items()})
    got = TS.composite_t_maps(t_values, device="cpu")
    assert sorted(got) == sorted(ref)
    for name in JS.COMPOSITE_METRICS:
        _close(got[name], ref[name])
        assert np.isnan(np.asarray(got[name])[5])


@pytest.mark.parametrize("n_subjects,p_within,n_group", [(3, 6, 20), (6, 10, 64), (4, 5, 1)])
def test_null_t_maps_match_jax(n_subjects, p_within, n_group):
    rng = np.random.RandomState(n_group)
    scores = _scores(rng, (n_subjects, p_within, 50))
    perms = JS.group_permutations(p_within, n_subjects, n_group)
    ref = np.asarray(JS.null_t_maps(jnp.asarray(scores), jnp.asarray(perms), 0.5))
    got = TS.null_t_maps(scores, perms, 0.5, device="cpu")
    assert got.shape == (n_group, 50)
    _close(got, ref)


def test_null_min_t_maps_match_the_jax_host_loop():
    """The composite null kept on the device equals the JAX package's host
    loop (decoding/permutation.py:429-456) over its member t-maps."""
    rng = np.random.RandomState(4)
    members = JS.COMPOSITE_METRICS[TS.METRIC_MOD_AGNOSTIC_AND_CROSS]
    stacks = [_scores(rng, (4, 7, 60)) for _ in members]
    stacks[1][..., 9] = np.nan  # NaN in one member only
    for s in stacks:  # NaN in every member
        s[..., 13] = np.nan
    perms = JS.group_permutations(7, 4, 40)
    t_min = np.full((40, 60), np.inf, dtype=np.float32)
    any_valid = np.zeros((40, 60), dtype=bool)
    for s in stacks:
        t = np.asarray(JS.null_t_maps(jnp.asarray(s), jnp.asarray(perms), 0.5))
        valid = ~np.isnan(t)
        t_min = np.where(valid & (t < t_min), t, t_min)
        any_valid |= valid
    t_min[~any_valid] = np.nan
    t_min[np.isinf(t_min)] = np.nan

    dev = [torch.as_tensor(s) for s in stacks]
    got = TS.null_min_t_maps(dev, perms, [0.5] * 4)
    _close(got, t_min)
    assert torch.isnan(got[:, 13]).all() and not torch.isnan(got[:, 9]).all()
    swept = torch.cat([c for _, c in TS.null_min_t_sweep(dev, perms, [0.5] * 4, chunk=16)])
    np.testing.assert_array_equal(swept.numpy(), got.numpy())


def test_group_permutations_equal_jax():
    for args in [(5, 3, 4), (100, 6, 300), (6, 3, 120)]:
        got = TS.group_permutations(*args)
        np.testing.assert_array_equal(got, JS.group_permutations(*args))
        assert got.dtype == np.int32
    with pytest.raises(ValueError, match="exceeds"):
        TS.group_permutations(3, 3, 7)


def test_p_values_and_cutoff_equal_jax():
    rng = np.random.RandomState(5)
    null_max = rng.gamma(2.0, 3.0, size=200)
    observed = np.concatenate([rng.gamma(2.0, 4.0, size=50), [-1.0, 0.0, np.nan, 1e9]])
    null_sorted = np.sort(null_max)
    np.testing.assert_array_equal(TS.p_values_from_null_max(observed, null_sorted),
                                  JS.p_values_from_null_max(observed, null_sorted))
    for thr in (0.05, 1e-4, 1 / 200, 0.5):
        got, got_distr = TS.significance_cutoff(null_max, thr)
        ref, ref_distr = JS.significance_cutoff(null_max, thr)
        assert got == ref
        np.testing.assert_array_equal(got_distr, ref_distr)
