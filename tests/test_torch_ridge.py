"""Port parity: the dual and primal ridge of ``ops/ridge.py`` vs the JAX package.

Seeded numpy inputs go through both packages on the CPU.  Tolerances: the
streamed kernels within 1e-5 relative (float32 sums in another block
order); dual coefficients and predictions within 1e-4 relative (Cholesky
solves of the same systems by two libraries); CV: equal ``best_idx`` and
mean CV scores within 1e-5.  The JAX ``"schur-pallas"`` selection reaches
its Pallas kernel in interpret mode, as the JAX package runs it off the TPU;
the port's runs the panel kernel's plain version on a CPU tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import ridge as JR
from multimodal_decoding_tpu_torch import interop
from multimodal_decoding_tpu_torch.ops import hopper_solvers as TH
from multimodal_decoding_tpu_torch.ops import ridge as TR

CPU = "cpu"
KERNEL_TOL = 1e-5
FIT_TOL = 1e-4
CV_TOL = 1e-5
ALPHAS = [1e0, 1e2, 1e3, 1e4, 1e6]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _problem(seed: int, n: int = 120, f: int = 700, d: int = 8, noise: float = 2.0):
    """A planted decode problem: X = Y G + noise, the whole-brain direction."""
    rng = np.random.RandomState(seed)
    Y = rng.randn(n, d).astype(np.float32)
    G = rng.randn(d, f).astype(np.float32) / np.sqrt(d)
    X = (Y @ G + noise * rng.randn(n, f)).astype(np.float32)
    return X, Y


# 700 columns in blocks of 256: two whole blocks and a ragged 188-column one;
# a block wider than X is the single-block case
@pytest.mark.parametrize("block_cols", [256, 1024])
def test_gram_and_cross_matrix_match_jax(block_cols):
    X, _ = _problem(0)
    Xq = np.random.RandomState(1).randn(9, X.shape[1]).astype(np.float32)
    K = TR.gram_matrix(X, block_cols=block_cols, device=CPU)
    assert K.dtype == torch.float32 and K.device.type == "cpu"
    assert _rel(K, JR.gram_matrix(X, block_cols=block_cols)) <= KERNEL_TOL
    Kq = TR.cross_matrix(Xq, X, block_cols=block_cols, device=CPU)
    assert _rel(Kq, JR.cross_matrix(Xq, X, block_cols=block_cols)) <= KERNEL_TOL
    # the one-pass form GramCache uses gives the same kernels
    K1, (Kq1,) = TR.streamed_kernels(X, (Xq,), block_cols=block_cols, device=CPU)
    torch.testing.assert_close(K1, K, rtol=0, atol=0)
    torch.testing.assert_close(Kq1, Kq, rtol=0, atol=0)


def test_dual_ridge_fit_and_predict_match_jax():
    X, Y = _problem(2)
    K = X @ X.T
    Kq = X[:7] @ X.T
    for alpha in (1e0, 1e3):
        ref = np.asarray(JR.dual_ridge_fit(jnp.asarray(K), jnp.asarray(Y), alpha))
        got = TR.dual_ridge_fit(K, Y, alpha, device=CPU)
        assert _rel(got, ref) <= FIT_TOL
        ref_p = np.asarray(JR.dual_ridge_predict(jnp.asarray(Kq), jnp.asarray(ref)))
        assert _rel(TR.dual_ridge_predict(Kq, got, device=CPU), ref_p) <= FIT_TOL


def test_dual_ridge_fit_all_alphas_eigh_matches_jax_and_cholesky():
    X, Y = _problem(3, n=60)
    K = (X @ X.T).astype(np.float32)
    alphas = np.array([1e2, 1e3, 1e4], np.float32)
    ref = np.asarray(JR.dual_ridge_fit_all_alphas_eigh(jnp.asarray(K), jnp.asarray(Y),
                                                        jnp.asarray(alphas)))
    got = TR.dual_ridge_fit_all_alphas_eigh(K, Y, alphas, device=CPU)
    assert got.shape == (3, 60, 8)
    assert _rel(got, ref) <= FIT_TOL
    for a, g in zip(alphas, got):
        assert _rel(g, TR.dual_ridge_fit(K, Y, float(a), device=CPU)) <= FIT_TOL


def test_primal_ridge_matches_jax():
    rng = np.random.RandomState(4)
    X = rng.randn(3, 40, 12).astype(np.float32)
    Y = rng.randn(3, 40, 5).astype(np.float32)
    ref = np.asarray(JR.ridge_fit_primal(jnp.asarray(X), jnp.asarray(Y), 3.0))
    got = TR.ridge_fit_primal(X, Y, 3.0, device=CPU)
    assert got.shape == (3, 12, 5)
    assert _rel(got, ref) <= FIT_TOL
    ref_p = np.asarray(JR.ridge_predict(jnp.asarray(X), jnp.asarray(ref)))
    assert _rel(TR.ridge_predict(X, got, device=CPU), ref_p) <= FIT_TOL


# noise from strong signal to near-noise, so the selected alpha moves over
# the grid; n = 243 leaves folds of 49/48 rows and n_tr = 194/195 > 192, so
# "schur-pallas" recurses once and reaches its base blocks (97/98)
@pytest.mark.parametrize("noise", [0.5, 4.0, 16.0])
@pytest.mark.parametrize("cv_solver", [None, "schur-cb", "schur-pallas"])
def test_ridge_cv_dual_matches_jax(cv_solver, noise):
    X, Y = _problem(5, n=243, f=400, noise=noise)
    K = X @ X.T
    # the JAX schur-cb selection has the port's schur-pallas base formula
    # (L^-1 of a Cholesky factor, then L^-T L^-1)
    jax_solver = "schur-cb" if cv_solver == "schur-pallas" else cv_solver
    ref_idx, ref_scores, ref_dual = JR.ridge_cv_dual(K, Y, ALPHAS, cv_solver=jax_solver)
    TH.reset_launches()
    idx, scores, dual = TR.ridge_cv_dual(K, Y, ALPHAS, cv_solver=cv_solver, device=CPU)
    assert TH.launches == 0  # the plain version on CPU tensors
    assert idx == ref_idx
    assert isinstance(scores, np.ndarray) and scores.shape == (len(ALPHAS),)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=CV_TOL)
    assert _rel(dual, ref_dual) <= FIT_TOL
    strict_idx, _, _ = TR.ridge_cv_dual(K, Y, ALPHAS, device=CPU)
    assert idx == strict_idx


def test_selected_alphas_spread_over_the_grid():
    """The noise sweep of test_ridge_cv_dual_matches_jax picks several alphas."""
    picks = {TR.ridge_cv_dual(X @ X.T, Y, ALPHAS, device=CPU)[0]
             for X, Y in (_problem(5, n=243, f=400, noise=s) for s in (0.5, 4.0, 16.0))}
    assert len(picks) >= 2, picks


def test_schur_pallas_fold_matches_jax_pallas_in_interpret_mode():
    """One fold (n_tr = 194 > 192: the Schur base blocks are reached) of the
    port's "schur-pallas" against the JAX one, whose kernel runs in
    interpret mode."""
    X, Y = _problem(6, n=240, f=400, noise=4.0)
    K = X @ X.T
    alphas = [1e1, 1e3, 1e5]
    ref = np.asarray(JR._cv_fold_scores_sliced(jnp.asarray(K), jnp.asarray(Y), 0, 46,
                                               jnp.asarray(alphas, jnp.float32),
                                               solver="schur-pallas"))
    got = TR._cv_fold_scores_sliced(torch.as_tensor(K), torch.as_tensor(Y), 0, 46, alphas,
                                    solver="schur-pallas")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=CV_TOL)


def test_non_contiguous_folds_take_the_gather_path(monkeypatch):
    """Folds that are not one range are gathered; same scores as slicing."""
    X, Y = _problem(7, n=50, f=200)
    K = X @ X.T
    ref = TR.ridge_cv_dual(K, Y, ALPHAS, device=CPU)
    folds = TR.kfold_indices(50, 5)
    # the same folds with each validation range reversed: not arange(lo, hi)
    monkeypatch.setattr(TR, "kfold_indices", lambda n, k: [(tr, va[::-1]) for tr, va in folds])
    got = TR.ridge_cv_dual(K, Y, ALPHAS, device=CPU)
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=CV_TOL)


def test_ridge_cv_dual_reports_stage_timings():
    X, Y = _problem(8, n=50, f=100)
    timings = {}
    TR.ridge_cv_dual(X @ X.T, Y, ALPHAS, device=CPU, timings=timings)
    assert set(timings) == {"cv_s", "refit_s"} and min(timings.values()) >= 0


def test_a_mesh_raises_naming_the_multi_gpu_item():
    """A feature mesh shards the kernels (here a gloo world of one: the same
    kernels as without it); the CV takes the replicated gram and no mesh."""
    import torch.distributed as dist

    from multimodal_decoding_tpu_torch.parallel.mesh import feature_mesh

    X, Y = _problem(9, n=20, f=30)
    try:
        mesh = feature_mesh(CPU)
        assert torch.equal(TR.gram_matrix(X, block_cols=7, mesh=mesh),
                           TR.gram_matrix(X, block_cols=7, device=CPU))
        assert torch.equal(TR.cross_matrix(X[:4], X, block_cols=7, mesh=mesh),
                           TR.cross_matrix(X[:4], X, block_cols=7, device=CPU))
    finally:
        dist.destroy_process_group()
    with pytest.raises(TypeError, match="mesh"):
        TR.ridge_cv_dual(X @ X.T, Y, ALPHAS, mesh="auto", device=CPU)


def test_port_starts_from_the_jax_whole_brain_state():
    """The JAX gram and dual coefficients, carried over, predict as the JAX
    package does."""
    X, Y = _problem(10, n=80, f=300)
    Xq = np.random.RandomState(11).randn(6, 300).astype(np.float32)
    K, Kq = np.asarray(JR.gram_matrix(X)), np.asarray(JR.cross_matrix(Xq, X))
    _, _, dual = JR.ridge_cv_dual(K, Y, ALPHAS)
    state = interop.whole_brain_state_from_numpy(device=CPU, K=K, K_test=Kq,
                                                 dual_coef=np.asarray(dual))
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in state.values())
    ref = np.asarray(JR.dual_ridge_predict(jnp.asarray(Kq), dual))
    assert _rel(TR.dual_ridge_predict(state["K_test"], state["dual_coef"], device=CPU),
                ref) <= FIT_TOL
    with pytest.raises(ValueError, match="unknown whole-brain state"):
        interop.whole_brain_state_from_numpy(device=CPU, W=K)
