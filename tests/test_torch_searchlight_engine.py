"""Port parity: the searchlight engine's block steps against the JAX package.

The same seeded numpy inputs, carried across with
``interop.block_inputs_from_numpy``, go through each of the four JAX block
steps and their PyTorch counterparts on the CPU.  The JAX CV steps run the
``"schur-pallas"`` selection solver with the Pallas panel kernel in
interpret mode, as the JAX package's own tests run it off the TPU.

Tolerances: score maps, null scores and selected alphas must be EQUAL (they
are ratios of integer rank counts); the refit weights agree within 1e-4
relative (float32 sums in another order).  Equality is only meaningful on
inputs without near-ties, so ``tie_margin`` recomputes every comparison the
scorers make in float64 and the fixture asserts each margin exceeds 1e-4,
far above float32 rounding (~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.decoding import searchlight_engine as JE
from multimodal_decoding_tpu.ops.ridge import ALPHA_TIE_TOL, kfold_indices
from multimodal_decoding_tpu_torch.decoding import searchlight_engine as TE
from multimodal_decoding_tpu_torch.interop import block_inputs_from_numpy, to_numpy

TIE_MARGIN = 1e-4
N_TRAIN, N_TEST, N_IMAG, D, V, K, B, P = 32, 10, 3, 8, 64, 6, 16, 4
ALPHAS = np.asarray([1e-1, 1e1, 1e3], dtype=np.float32)
FIXED_ALPHA = 1e1
STIM_TYPES = np.array(["caption"] * 5 + ["image"] * 5)
# the seed in 0..1499 whose inputs clear TIE_MARGIN by the most (1.76e-4),
# and whose vertices select each of the three alphas
SEED = 145


def make_block_problem(seed: int) -> dict:
    """``__graft_entry__.entry()``-sized block inputs, plus shuffles and derangements."""
    rng = np.random.RandomState(seed)
    half = N_TEST // 2
    shuffles = np.stack([
        np.concatenate([rng.permutation(half), half + rng.permutation(half)])
        for _ in range(P)
    ]).astype(np.int32)
    return dict(
        X_all=rng.randn(N_TRAIN + N_TEST + N_IMAG, V).astype(np.float32),
        Y_train=rng.randn(N_TRAIN, D).astype(np.float32),
        Y_test=rng.randn(N_TEST, D).astype(np.float32),
        Y_imag=rng.randn(N_IMAG, D).astype(np.float32),
        idx=np.stack([rng.choice(V, size=K, replace=False) for _ in range(B)]).astype(np.int32),
        alphas=ALPHAS,
        shuffles=shuffles,
        derangements=rng.randint(0, 2, (B, P)).astype(np.int32),
    )


def _gaps(d: np.ndarray, diag_only: bool) -> float:
    """Smallest gap between two entries of a row that a scorer compares."""
    if diag_only:  # pairwise accuracy: the diagonal against the rest of its row
        n = d.shape[-2]
        diag = np.diagonal(d, axis1=-2, axis2=-1)[..., :, None]
        g = np.abs(d - diag)
        g[..., np.arange(n), np.arange(n)] = np.inf
        return float(g.min())
    # rank counts: every pair of entries in a row
    g = np.abs(d[..., :, None] - d[..., None, :])
    m = d.shape[-1]
    g[..., np.arange(m), np.arange(m)] = np.inf
    return float(g.min())


def _cos(p: np.ndarray, l: np.ndarray) -> np.ndarray:
    p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    l = l / np.linalg.norm(l, axis=-1, keepdims=True)
    return p @ np.swapaxes(l, -1, -2)


def _std(x: np.ndarray) -> np.ndarray:
    s = x.std(axis=-2, keepdims=True)
    return (x - x.mean(axis=-2, keepdims=True)) / np.where(s == 0, 1.0, s)


def tie_margin(prob: dict, n_train: int, n_test: int, stim_types, fixed_alpha,
               n_splits: int = 5):
    """(smallest comparison gap, float64-selected alphas [B]) of the block steps.

    Covers the CV fold scorer at every (fold, alpha) and the final score
    families (including the all-pairs rank counts behind the null scores) at
    the fixed alpha and at each vertex's selected alpha.
    """
    Xg = prob["X_all"].astype(np.float64)[:, prob["idx"]]  # [N_all, B, K]
    Xtr, Xte, Xim = Xg[:n_train], Xg[n_train:n_train + n_test], Xg[n_train + n_test:]
    Ytr, Yte, Yim = (prob[k].astype(np.float64) for k in ("Y_train", "Y_test", "Y_imag"))
    alphas = prob["alphas"].astype(np.float64)
    k = Xg.shape[-1]
    G = np.einsum("nbk,nbl->bkl", Xtr, Xtr)
    XtY = np.einsum("nbk,nd->bkd", Xtr, Ytr)
    margin = np.inf
    scores = np.zeros((len(alphas), Xg.shape[1]))
    for _, val in kfold_indices(n_train, n_splits):
        Xv, Yv = Xtr[val], Ytr[val]
        G_tr = G - np.einsum("nbk,nbl->bkl", Xv, Xv)
        XtY_tr = XtY - np.einsum("nbk,nd->bkd", Xv, Yv)
        for a, alpha in enumerate(alphas):
            W = np.linalg.solve(G_tr + alpha * np.eye(k), XtY_tr)
            sim = _cos(np.einsum("nbk,bkd->bnd", Xv, W), Yv)
            margin = min(margin, _gaps(sim, diag_only=True))
            nv = len(val)
            diag = np.diagonal(sim, axis1=-2, axis2=-1)[..., :, None]
            scores[a] += (sim < diag).sum(axis=(-2, -1)) / (nv * nv - nv) / n_splits
    best = np.argmax(scores >= scores.max(axis=0) - ALPHA_TIE_TOL, axis=0)
    selected = alphas[best]

    cap, img = stim_types == "caption", stim_types == "image"
    L_whole = np.concatenate([Yim, Yte])
    for per_vertex in (np.full(Xg.shape[1], fixed_alpha), selected):
        W = np.linalg.solve(G + per_vertex[:, None, None] * np.eye(k), XtY)
        pt = np.einsum("mbk,bkd->bmd", Xte, W)
        pi = np.einsum("mbk,bkd->bmd", Xim, W)
        Pc, Pi = _std(pt[:, cap]), _std(pt[:, img])
        margin = min(margin,
                     _gaps(_cos(Pc, Yte[cap]), False), _gaps(_cos(Pi, Yte[img]), False),
                     _gaps(_cos(Pc, Yte[img]), True), _gaps(_cos(Pi, Yte[cap]), True))
        for P_im in (_std(pi), pi):
            margin = min(margin, _gaps(_cos(P_im, Yim), False),
                         _gaps(_cos(P_im, L_whole), False))
    return margin, selected.astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    prob = make_block_problem(SEED)
    margin, selected = tie_margin(prob, N_TRAIN, N_TEST, STIM_TYPES, FIXED_ALPHA)
    assert margin > TIE_MARGIN, f"seed {SEED} inputs are not tie-free: margin {margin:.2e}"
    prob["selected_f64"] = selected
    return prob


def _torch_inputs(prob):
    keys = ("X_all", "Y_train", "Y_test", "Y_imag", "idx", "alphas", "shuffles",
            "derangements")
    return block_inputs_from_numpy(device="cpu", **{k: prob[k] for k in keys})


def _assert_equal_dicts(jax_out, torch_out):
    # jit hands dicts back with sorted keys, so only the key sets compare
    assert sorted(jax_out) == sorted(torch_out)
    for m in jax_out:
        j, t = np.asarray(jax_out[m]), torch_out[m]
        assert j.dtype == t.dtype, (m, j.dtype, t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=m)


COMMON = dict(n_train=N_TRAIN, n_test=N_TEST)


def test_interop_keeps_dtypes_and_layouts(problem):
    t = _torch_inputs(problem)
    for name, tensor in t.items():
        assert tuple(tensor.shape) == problem[name].shape, name
        assert str(tensor.dtype).split(".")[-1] == problem[name].dtype.name, name
        np.testing.assert_array_equal(tensor.numpy(), problem[name])
    assert block_inputs_from_numpy(device="cpu", mask=None) == {"mask": None}
    with pytest.raises(ValueError, match="unknown block inputs"):
        block_inputs_from_numpy(device="cpu", weights=np.zeros(3))


def test_searchlight_block_matches_jax(problem):
    p, t = problem, _torch_inputs(problem)
    ref = JE.searchlight_block(p["X_all"], p["Y_train"], p["Y_test"], p["Y_imag"], p["idx"],
                               None, FIXED_ALPHA,
                               layout=JE.TestLayout.from_stim_types(STIM_TYPES), **COMMON)
    got = TE.searchlight_block(t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"],
                               None, FIXED_ALPHA,
                               layout=TE.TestLayout.from_stim_types(STIM_TYPES), **COMMON)
    _assert_equal_dicts(ref, to_numpy(got))


def test_searchlight_block_with_null_matches_jax(problem):
    p, t = problem, _torch_inputs(problem)
    ref = JE.searchlight_block_with_null(
        p["X_all"], p["Y_train"], p["Y_test"], p["Y_imag"], p["idx"], None, FIXED_ALPHA,
        p["shuffles"], p["derangements"],
        layout=JE.TestLayout.from_stim_types(STIM_TYPES), **COMMON)
    got = TE.searchlight_block_with_null(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], None, FIXED_ALPHA,
        t["shuffles"], t["derangements"],
        layout=TE.TestLayout.from_stim_types(STIM_TYPES), **COMMON)
    for r, g in zip(ref, to_numpy(got)):
        _assert_equal_dicts(r, g)


def test_searchlight_block_cv_matches_jax(problem):
    p, t = problem, _torch_inputs(problem)
    ref = JE.searchlight_block_cv(
        p["X_all"], p["Y_train"], p["Y_test"], p["Y_imag"], p["idx"], None, p["alphas"],
        layout=JE.TestLayout.from_stim_types(STIM_TYPES), cv_solver="schur-pallas",
        cv_precision=jax.lax.Precision.DEFAULT, **COMMON)
    got = TE.searchlight_block_cv(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], None, t["alphas"],
        layout=TE.TestLayout.from_stim_types(STIM_TYPES), cv_solver="schur-pallas", **COMMON)
    got = to_numpy(got)
    _assert_equal_dicts(ref, got)
    np.testing.assert_array_equal(got["best_alpha"], problem["selected_f64"])


def test_searchlight_block_cv_with_null_matches_jax(problem):
    """The main path's block step: CV selection + refit + score + null."""
    p, t = problem, _torch_inputs(problem)
    ref = JE.searchlight_block_cv_with_null(
        p["X_all"], p["Y_train"], p["Y_test"], p["Y_imag"], p["idx"], None, p["alphas"],
        p["shuffles"], p["derangements"],
        layout=JE.TestLayout.from_stim_types(STIM_TYPES), cv_solver="schur-pallas",
        cv_precision=jax.lax.Precision.DEFAULT, **COMMON)
    got = TE.searchlight_block_cv_with_null(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], None, t["alphas"],
        t["shuffles"], t["derangements"],
        layout=TE.TestLayout.from_stim_types(STIM_TYPES), cv_solver="schur-pallas", **COMMON)
    for r, g in zip(ref, to_numpy(got)):
        _assert_equal_dicts(r, g)


# (cv_scorer, cv_solver): the dense scorers on "schur-cb"; each streamed-count
# scorer (Pallas kernels in interpret mode on the JAX side) on the strict
# solver and on the selection solver with the panel kernel
_CV_CASES = [pytest.param("xla", "schur-cb", id="xla"),
             pytest.param("strict", "schur-cb", id="strict")] + [
    pytest.param(scorer, solver, id=f"{scorer}-{solver}")
    for scorer in ("pallas", "fused", "fused-pallas", "fused-inv")
    for solver in ("cholesky", "schur-pallas")]


@pytest.mark.parametrize("cv_scorer,cv_solver", _CV_CASES)
def test_fit_block_cv_weights_match_jax(problem, cv_scorer, cv_solver):
    """W [B, K, D], best_alpha and the CV scores of fit_block_cv in both packages."""
    p, t = problem, _torch_inputs(problem)
    Xj = JE.gather_patches(jnp.asarray(p["X_all"]), jnp.asarray(p["idx"]))[:N_TRAIN]
    Xt = TE.gather_patches(t["X_all"], t["idx"])[:N_TRAIN]
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    Wj, aj, sj = JE.fit_block_cv(Xj, p["Y_train"], jnp.asarray(p["alphas"]),
                                 cv_precision=jax.lax.Precision.HIGHEST,
                                 cv_solver=cv_solver, cv_scorer=cv_scorer)
    Wt, at, st = TE.fit_block_cv(Xt, t["Y_train"], t["alphas"], cv_solver=cv_solver,
                                 cv_scorer=cv_scorer)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    # fold means of equal counts; eager JAX divides where jit multiplies by
    # the reciprocal, so the last bit may differ (inside the 1e-6 tie band)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    Wj = np.asarray(Wj)
    rel = np.linalg.norm(Wt.numpy() - Wj) / np.linalg.norm(Wj)
    assert rel <= 1e-4, rel
    if cv_scorer.startswith("fused"):
        # reassociated through K: the JAX package's bar against its xla scorer
        sx = TE.fit_block_cv(Xt, t["Y_train"], t["alphas"], cv_solver=cv_solver,
                             cv_scorer="xla")[2]
        np.testing.assert_allclose(st.numpy(), sx.numpy(), rtol=0, atol=5e-5)


def test_score_families_match_jax(problem):
    """score_block, null_score_block and score_and_null_block on shared predictions."""
    p, t = problem, _torch_inputs(problem)
    rng = np.random.RandomState(SEED)
    W = rng.randn(B, K, D).astype(np.float32)
    Xg = p["X_all"][:, p["idx"]]
    pt = np.einsum("mbk,bkd->bmd", Xg[N_TRAIN:N_TRAIN + N_TEST], W).astype(np.float32)
    pi = np.einsum("mbk,bkd->bmd", Xg[N_TRAIN + N_TEST:], W).astype(np.float32)
    prob = {**p, "preds": (pt, pi)}
    jl, tl = JE.TestLayout.from_stim_types(STIM_TYPES), TE.TestLayout.from_stim_types(STIM_TYPES)
    tp, ti = torch.as_tensor(pt), torch.as_tensor(pi)
    jit_score = jax.jit(JE.score_block, static_argnames=("layout",))
    _assert_equal_dicts(jit_score(pt, pi, p["Y_test"], p["Y_imag"], layout=jl),
                        to_numpy(TE.score_block(tp, ti, t["Y_test"], t["Y_imag"], tl)))
    jit_null = jax.jit(JE.null_score_block, static_argnames=("layout", "null_gather"))
    for mode in ("gather", "onehot"):
        _assert_equal_dicts(
            jit_null(pt, pi, p["Y_test"], p["Y_imag"], layout=jl, shuffles=p["shuffles"],
                     imagery_derangements=p["derangements"], null_gather=mode),
            to_numpy(TE.null_score_block(tp, ti, t["Y_test"], t["Y_imag"], tl,
                                         t["shuffles"], t["derangements"], mode)))
    jit_both = jax.jit(JE.score_and_null_block,
                       static_argnames=("layout", "comp_cross_decoding_scores"))
    ref = jit_both(pt, pi, p["Y_test"], p["Y_imag"], layout=jl, shuffles=p["shuffles"],
                   imagery_derangements=p["derangements"], comp_cross_decoding_scores=False)
    got = TE.score_and_null_block(tp, ti, t["Y_test"], t["Y_imag"], tl, t["shuffles"],
                                  t["derangements"], comp_cross_decoding_scores=False)
    for r, g in zip(ref, to_numpy(got)):
        _assert_equal_dicts(r, g)
    margin = tie_margin_of_preds(prob)
    assert margin > TIE_MARGIN, margin


def tie_margin_of_preds(prob) -> float:
    """Smallest comparison gap of the score families on given predictions."""
    pt, pi = (x.astype(np.float64) for x in prob["preds"])
    Yte, Yim = prob["Y_test"].astype(np.float64), prob["Y_imag"].astype(np.float64)
    cap, img = STIM_TYPES == "caption", STIM_TYPES == "image"
    Pc, Pi = _std(pt[:, cap]), _std(pt[:, img])
    L_whole = np.concatenate([Yim, Yte])
    return min(_gaps(_cos(Pc, Yte[cap]), False), _gaps(_cos(Pi, Yte[img]), False),
               _gaps(_cos(Pc, Yte[img]), True), _gaps(_cos(Pi, Yte[cap]), True),
               *[_gaps(_cos(P_im, L), False) for P_im in (_std(pi), pi)
                 for L in (Yim, L_whole)])


def test_masked_gather_matches_jax(problem):
    rng = np.random.RandomState(1)
    mask = rng.rand(B, K) > 0.3
    t = block_inputs_from_numpy(device="cpu", X_all=problem["X_all"], idx=problem["idx"],
                                mask=mask)
    got = TE.gather_patches(t["X_all"], t["idx"], t["mask"]).numpy()
    ref = np.asarray(JE.gather_patches(problem["X_all"], problem["idx"], mask))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["gather", "onehot", "onehot-bf16"])
@pytest.mark.parametrize("m", [9, 300])
def test_gather_perm_diag_modes_match_jax(mode, m):
    """All three null-gather modes, shared [P, n] shuffles and per-vertex
    [B, P, n] picks; m = 300 > 256 exercises the bf16 -> f32 fallback."""
    rng = np.random.RandomState(m)
    C = rng.randint(0, m, (3, 8, m)).astype(np.int32)
    perm2 = np.stack([rng.permutation(m)[:8] for _ in range(5)]).astype(np.int32)
    perm3 = rng.randint(0, m, (3, 5, 8)).astype(np.int32)
    for perm in (perm2, perm3):
        ref = np.asarray(jax.jit(JE._gather_perm_diag, static_argnums=2)(
            jnp.asarray(C), jnp.asarray(perm), mode))
        got = TE._gather_perm_diag(torch.as_tensor(C), torch.as_tensor(perm), mode).numpy()
        np.testing.assert_array_equal(got.astype(np.float32), ref.astype(np.float32))


def test_rank_counts_match_jax():
    rng = np.random.RandomState(2)
    dist = rng.rand(4, 3, 143).astype(np.float32)
    ref = np.asarray(JE._rank_counts(jnp.asarray(dist)))
    np.testing.assert_array_equal(TE._rank_counts(torch.as_tensor(dist)).numpy(), ref)


def test_unported_options_raise(problem):
    """The JAX package's selection options run in the port now (their parity
    is tests/test_torch_precision.py's); what still raises is what the JAX
    package rejects too."""
    t = _torch_inputs(problem)
    X = TE.gather_patches(t["X_all"], t["idx"])[:N_TRAIN]
    for kw in ({"cv_dtype": torch.bfloat16}, {"cv_alpha_batch": True}):
        _, best, scores = TE.fit_block_cv(X, t["Y_train"], t["alphas"], **kw)
        assert best.shape == (B,) and scores.shape == (B, len(ALPHAS))
    with pytest.raises(ValueError, match="must divide"):
        TE.fit_block_cv(X, t["Y_train"], t["alphas"], cv_alpha_batch=2)
    with pytest.raises(ValueError, match="requires cv_scorer='xla'"):
        TE.fit_block_cv(X, t["Y_train"], t["alphas"], cv_alpha_batch=True, cv_scorer="pallas")
    with pytest.raises(ValueError, match="unknown cv_scorer"):
        TE.fit_block_cv(X, t["Y_train"], t["alphas"], cv_scorer="fused-bf16")
    with pytest.raises(ValueError, match="unknown null-gather mode"):
        TE._gather_perm_diag(torch.zeros(1, 2, 2), torch.zeros(1, 2, dtype=torch.long),
                             "scatter")
    preds = torch.zeros(1, N_TEST, D)
    with pytest.raises(ValueError, match="3-element imagery"):
        TE.score_and_null_block(preds, torch.zeros(1, 2, D), t["Y_test"], t["Y_imag"][:2],
                                TE.TestLayout.from_stim_types(STIM_TYPES), t["shuffles"],
                                t["derangements"][:1])


# ---------------------------------------------------------------------------
# The aligned layout of 16-bit patches (gather_patches)
# ---------------------------------------------------------------------------


def _aligned_gathers(fn):
    """(fn's result, the ``mdt.engine.aligned_gather`` count while it ran)."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_decoding_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    n = profiling.summary()["counters"].get("mdt.engine.aligned_gather", 0)
    profiling.reset()
    return out, n


def _gather_inputs(k, dtype, masked, n=20, b=3, v=900):
    gen = torch.Generator().manual_seed(k)
    X = torch.randn((n, v), generator=gen).to(dtype)
    idx = torch.randint(0, v, (b, k), generator=gen, dtype=torch.int32)
    mask = torch.rand((b, k), generator=gen) > 0.3 if masked else None
    dense = X[:, idx.long()]
    if masked:
        dense = dense * mask[None].to(dtype)
    return X, idx, mask, dense


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("k", [750, 804, 13])
def test_gather_patches_aligns_16_bit_rows(k, masked):
    """bf16 patches whose rows are not 16 bytes apart come as the [N, B, K]
    view of a buffer whose rows, vertices and pad columns are 8-element
    aligned and zeroed past K, equal to the dense gather; one count a gather."""
    X, idx, mask, dense = _gather_inputs(k, torch.bfloat16, masked)
    got, n = _aligned_gathers(lambda: TE.gather_patches(X, idx, mask))
    kp = -(-k // 8) * 8
    assert n == 1
    assert got.shape == dense.shape and torch.equal(got, dense)
    assert got.stride() == (idx.shape[0] * kp, kp, 1)
    assert got.stride(0) % 8 == 0 and got.stride(1) % 8 == 0
    pad = got.as_strided((got.shape[0], got.shape[1], kp - k), got.stride(), k)
    assert torch.all(pad == 0)
    assert TE._row_pitch(got) == kp and TE._row_pitch(got[5:9]) == kp


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype,k", [(torch.bfloat16, 8), (torch.bfloat16, 752),
                                     (torch.float32, 750), (torch.float32, 13)],
                         ids=["bf16-8", "bf16-752", "float32-750", "float32-13"])
def test_gather_patches_keeps_dense_layouts(dtype, k, masked):
    """Float32 patches, and bf16 patches whose rows are already 16 bytes
    apart, keep the dense [N, B, K] layout, uncounted."""
    X, idx, mask, dense = _gather_inputs(k, dtype, masked)
    got, n = _aligned_gathers(lambda: TE.gather_patches(X, idx, mask))
    assert n == 0
    assert torch.equal(got, dense) and got.stride() == (idx.shape[0] * k, k, 1)
    assert TE._row_pitch(got) == k


def _fast_math_inputs(problem):
    t = _torch_inputs(problem)
    t["X_all"] = t["X_all"].to(torch.bfloat16)
    return t


def _dense_gather(X, idx, mask=None):
    patches = X[:, idx.long()]
    return patches if mask is None else patches * mask[None].to(patches.dtype)


def test_aligned_patch_slices_start_16_bytes_apart(problem):
    """The train, test and imagery slices of one aligned gather (K = 6: rows
    of 12 bytes) each start a multiple of 8 elements into the buffer."""
    t = _fast_math_inputs(problem)
    for part in TE._split_patches(t["X_all"], t["idx"], None, N_TRAIN, N_TEST):
        assert part.storage_offset() % 8 == 0 and part.stride() == (B * 8, 8, 1)


def _block_call(name, t, patches):
    """One of the engine's functions under ``--fast-math``'s precision on the
    given [N_all, B, K] patches."""
    Xtr, Xte = patches[:N_TRAIN], patches[N_TRAIN:N_TRAIN + N_TEST]
    if name == "fit_block":
        return TE.fit_block(Xtr, t["Y_train"], FIXED_ALPHA, precision="default")
    if name == "predict_block":
        W = torch.as_tensor(np.random.RandomState(3).randn(B, K, D).astype(np.float32))
        return TE.predict_block(Xte, W.to(torch.bfloat16), "default",
                                out_dtype=torch.bfloat16).float()
    scorer, cv_dtype = name.split(":")[1:]
    return TE.fit_block_cv(Xtr, t["Y_train"], t["alphas"], precision="default",
                           cv_precision="default", cv_scorer=scorer,
                           cv_dtype=None if cv_dtype == "none" else torch.bfloat16)


_BLOCK_CALLS = ["fit_block", "predict_block"] + [
    f"fit_block_cv:{scorer}:{dt}" for scorer, dt in
    (("xla", "none"), ("pallas", "bf16"), ("fused", "none"), ("fused-pallas", "bf16"),
     ("fused-pallas", "none"), ("fused-inv", "none"))]


@pytest.mark.parametrize("name", _BLOCK_CALLS)
def test_block_functions_on_aligned_patches_equal_a_dense_copy(problem, name):
    """The fit, predictions and CV selection on aligned bf16 patches against
    the same calls on a dense copy: the same bf16 operands, exact products
    and float32 sums, in another order at most; equal selections and scores."""
    t = _fast_math_inputs(problem)
    aligned = TE.gather_patches(t["X_all"], t["idx"])
    assert aligned.stride(1) == 8
    dense = _dense_gather(t["X_all"], t["idx"])
    got, ref = _block_call(name, t, aligned), _block_call(name, t, dense)
    if name.startswith("fit_block_cv"):
        (got, best_g, scores_g), (ref, best_r, scores_r) = got, ref
        assert torch.equal(best_g, best_r) and torch.equal(scores_g, scores_r)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_block_step_with_null_on_aligned_patches_equals_a_dense_copy(problem, monkeypatch,
                                                                     masked):
    """``searchlight_block_with_null`` under ``--fast-math``: equal scores and
    nulls whether the step gathers aligned or dense patches, and one
    ``mdt.engine.aligned_gather`` a step."""
    t = _fast_math_inputs(problem)
    mask = (torch.as_tensor(np.random.RandomState(4).rand(B, K)) > 0.2) if masked else None

    def step():
        return TE.searchlight_block_with_null(
            t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], mask, FIXED_ALPHA,
            t["shuffles"], t["derangements"], layout=TE.TestLayout.from_stim_types(STIM_TYPES),
            precision="default", **COMMON)

    got, n = _aligned_gathers(lambda: (step(), step())[0])
    assert n == 2
    monkeypatch.setattr(TE, "gather_patches", _dense_gather)
    ref, n = _aligned_gathers(step)
    assert n == 0
    for g, r in zip(to_numpy(got), to_numpy(ref)):
        _assert_equal_dicts(r, g)
