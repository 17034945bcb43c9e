"""Port parity: the SPD solvers and the panel kernel's plain version vs the JAX package.

The JAX side reaches its Pallas kernel in interpret mode, as
tests/test_pallas_solvers.py runs it off the TPU.  Tolerance: relative
Frobenius error <= 1e-5 on ``A = X^T X + alpha I`` (the JAX kernel's own
error against float64 is ~1e-7 here; the two float32 implementations sum in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import pallas_solvers as JP
from multimodal_decoding_tpu.ops import solvers as JS
from multimodal_decoding_tpu_torch.ops import hopper_solvers as TH
from multimodal_decoding_tpu_torch.ops import solvers as TS

REL_TOL = 1e-5


def _spd(seed: int, b: int, k: int, alpha: float = None) -> np.ndarray:
    """[b, k, k] float32 ``X^T X + alpha I`` with X [b, 3k, k] standard normal."""
    rng = np.random.RandomState(seed)
    X = rng.randn(b, 3 * k, k).astype(np.float32)
    alpha = float(k) if alpha is None else alpha
    return (np.einsum("bnk,bnl->bkl", X, X) + alpha * np.eye(k)).astype(np.float32)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# (2, 187) and (2, 188): the four base blocks of the schur-pallas inverse of
# K = 750, the panel kernel's shapes on the main path
@pytest.mark.parametrize("b,pb", [(3, 16), (4, 100), (2, 187), (2, 188)])
def test_chol_inv_panel_plain_matches_jax_kernel(b, pb):
    A = _spd(pb, b, pb)
    ref = np.asarray(JP.chol_inv_panel(A, interpret=True))
    got = TH.chol_inv_panel(torch.as_tensor(A))  # CPU tensor: the plain version
    assert _rel(got, ref) <= REL_TOL
    assert np.all(np.triu(got.numpy(), 1) == 0.0)
    L = np.linalg.cholesky(A.astype(np.float64))
    assert _rel(got, np.linalg.inv(L)) <= REL_TOL


def test_chol_inv_panel_cpu_path_does_not_count_launches():
    TH.reset_launches()
    TH.chol_inv_panel(torch.as_tensor(_spd(0, 2, 8)))
    assert TH.launches == 0
    with pytest.raises(ValueError, match=r"\[B, PB, PB\]"):
        TH.chol_inv_panel(torch.zeros(2, 3, 4))


# K=200 > 192: the Schur recursion runs; schur-pallas halves it into two
# 100 x 100 base blocks for the panel kernel (interpret mode on the JAX side)
@pytest.mark.parametrize("method", ["cholesky", "schur", "schur-cb", "schur-pallas"])
def test_spd_inverse_and_solve_match_jax(method):
    A = _spd(1, 2, 200)
    rhs = np.random.RandomState(2).randn(2, 200, 7).astype(np.float32)
    ref_inv = np.asarray(JS.spd_inverse(jnp.asarray(A), method=method))
    got_inv = TS.spd_inverse(torch.as_tensor(A), method=method)
    assert _rel(got_inv, ref_inv) <= REL_TOL
    ref_x = np.asarray(JS.spd_solve(jnp.asarray(A), jnp.asarray(rhs), method=method))
    got_x = TS.spd_solve(torch.as_tensor(A), torch.as_tensor(rhs), method=method)
    assert _rel(got_x, ref_x) <= REL_TOL


@pytest.mark.parametrize("k", [64, 70])
def test_blocked_spd_inverse_matches_jax(k):
    """K=70 pads to 80 with an identity corner; slicing back is exact."""
    A = _spd(k, 2, k)
    ref = np.asarray(JP.blocked_spd_inverse(A, panel=16, interpret=True))
    got = TH.blocked_spd_inverse(torch.as_tensor(A), panel=16)
    assert got.shape == (2, k, k)
    assert _rel(got, ref) <= REL_TOL


def test_pallas_method_solves_at_production_alphas():
    """spd_solve(method="pallas") (PANEL=64, K padded 48 -> 64) on gram + alpha
    at the ends of the production alpha grid, against the JAX Cholesky solve."""
    rng = np.random.RandomState(4)
    X = rng.randn(800, 48).astype(np.float32)
    G = X.T @ X
    rhs = rng.randn(1, 48, 5).astype(np.float32)
    for alpha in (1e2, 1e7):
        A = (G + alpha * np.eye(48, dtype=np.float32))[None]
        ref = np.asarray(JS.spd_solve(jnp.asarray(A), jnp.asarray(rhs), method="cholesky"))
        got = TS.spd_solve(torch.as_tensor(A), torch.as_tensor(rhs), method="pallas")
        assert _rel(got, ref) <= REL_TOL, alpha


@pytest.mark.parametrize("method", ["schur-cb16", "schur-cb16-ns", "tri-inv"])
def test_unported_methods_raise(method):
    """The JAX package's bf16 and triangular-inverse methods are ported now:
    they solve (within the JAX bands of tests/test_solvers.py:59-60) and
    invert, and only a name neither package knows raises."""
    A = torch.as_tensor(_spd(5, 1, 8))
    B = torch.eye(8)[None]
    inv = TS.spd_inverse(A, method=method)
    tol = {"schur-cb16": 2e-2, "schur-cb16-ns": 2e-4, "tri-inv": 5e-5}[method]
    ref = torch.linalg.inv(A.double())
    assert _rel(inv, ref) <= tol
    assert _rel(TS.spd_solve(A, B, method=method), ref) <= tol
    with pytest.raises(ValueError, match="unknown"):
        TS.spd_solve(A, A, method="qr")
    with pytest.raises(ValueError, match="unknown"):
        TS.spd_inverse(A, method="qr")

# ---------------------------------------------------------------------------
# The blocked Cholesky solve (the strict solve on the card; B1 runs its plain
# version here), against float64 torch.cholesky_solve of the same float32 A
# ---------------------------------------------------------------------------

SOLVE_KS = [1, 64, 187, 192, 193, 375, 750, 804]


def _spd_torch(seed: int, b: int, k: int, alpha: float, masked=()) -> torch.Tensor:
    """[b, k, k] float32 ``X^T X + alpha I``, X [b, 3k, k] standard normal
    with the columns ``masked`` zeroed (radius mode's pad columns)."""
    X = torch.as_tensor(np.random.RandomState(seed).randn(b, 3 * k, k))
    X[:, :, list(masked)] = 0.0
    return (X.mT @ X + alpha * torch.eye(k, dtype=torch.float64)).to(torch.float32)


def _float64_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    A, B = A.double(), B.double()
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


@pytest.mark.parametrize("k", SOLVE_KS)
def test_cholesky_panels_are_near_equal_and_at_most_max_panel(k):
    edges = TH.cholesky_panels(k)
    sizes = np.diff(edges)
    assert edges[0] == 0 and edges[-1] == k
    assert len(sizes) == -(-k // TH.MAX_PANEL)
    assert sizes.max() <= TH.MAX_PANEL and sizes.max() - sizes.min() <= 1
    assert list(sizes) == sorted(sizes, reverse=True)
    if k in (750, 804):
        assert list(sizes) == {750: [188, 188, 187, 187], 804: [161] * 4 + [160]}[k]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d", [1, 1024])
@pytest.mark.parametrize("k", SOLVE_KS)
def test_blocked_cholesky_solve_matches_float64(k, d, b):
    A = _spd_torch(k, b, k, alpha=float(k))
    B = torch.as_tensor(np.random.RandomState(k + 1).randn(b, k, d).astype(np.float32))
    got = TH.blocked_cholesky_solve(A, B)
    assert got.dtype == torch.float32 and got.shape == (b, k, d)
    assert _rel(got, _float64_solve(A, B)) <= REL_TOL


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [750, 804])
def test_blocked_cholesky_solve_with_masked_columns(k, b):
    """Radius mode's masked systems: a zeroed column leaves only alpha on its
    diagonal, so the system stays SPD and that weight is B / alpha; alpha 1,
    the fixed-alpha searchlight's, and pad columns in the first and last
    panels and across a panel edge."""
    masked = [0, 5, 187, 188, 189, k - 40, k - 1]
    A = _spd_torch(k + b, b, k, alpha=1.0, masked=masked)
    B = torch.as_tensor(np.random.RandomState(k).randn(b, k, 1024).astype(np.float32))
    got = TH.blocked_cholesky_solve(A, B)
    ref = _float64_solve(A, B)
    assert _rel(got, ref) <= REL_TOL
    assert torch.allclose(got[:, masked].double(), B[:, masked].double(), rtol=1e-6, atol=0)


def test_blocked_cholesky_solve_broadcasts_and_leaves_its_inputs():
    """Batch dimensions broadcast as torch.cholesky_solve's do; A and B unchanged."""
    A = _spd_torch(7, 1, 200, alpha=200.0)
    B = torch.as_tensor(np.random.RandomState(8).randn(2, 3, 200, 5).astype(np.float32))
    A0, B0 = A.clone(), B.clone()
    got = TH.blocked_cholesky_solve(A[0], B)  # A unbatched
    assert got.shape == (2, 3, 200, 5)
    assert _rel(got, _float64_solve(A[0], B)) <= REL_TOL
    assert torch.equal(A, A0) and torch.equal(B, B0)


@pytest.mark.parametrize("k", [193, 750])
def test_blocked_cholesky_factor_is_the_cholesky_factor(k):
    """The shared factor: L's blocks below the diagonal panels and each
    panel's L_pp^-1, against float64 numpy."""
    A = _spd_torch(k, 2, k, alpha=float(k))
    edges = TH.cholesky_panels(k)
    F, d_invs = TH.blocked_cholesky(A, edges)
    L = np.linalg.cholesky(A.double().numpy())
    for p, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        assert _rel(d_invs[p], np.linalg.inv(L[:, lo:hi, lo:hi])) <= REL_TOL
        if hi < k:
            assert _rel(F[:, hi:, lo:hi], L[:, hi:, lo:hi]) <= REL_TOL


@pytest.mark.parametrize("shape", [(2, 48, 48, 5), (1, 200, 200, 1), (3, 750, 750, 64)])
def test_spd_solve_cholesky_on_the_cpu_is_torch_cholesky_solve(shape):
    """On a CPU tensor the strict solve stays the library's, bit for bit, and
    the blocked solve's counter does not count, even while a profile records."""
    b, k, _, d = shape
    A = _spd_torch(k, b, k, alpha=float(k))
    B = torch.as_tensor(np.random.RandomState(k).randn(b, k, d).astype(np.float32))
    ref = torch.cholesky_solve(B, torch.linalg.cholesky(A))
    from multimodal_decoding_tpu_torch.utils import profiling
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = TS.spd_solve(A, B, method="cholesky")
    assert torch.equal(got, ref)
    assert "mdt.solve.blocked" not in profiling.summary()["counters"]
    profiling.reset()
