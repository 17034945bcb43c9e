"""Batched surface-searchlight engine: closed-form ridge over vertex blocks + scoring.

Port of ``multimodal_decoding_tpu/decoding/searchlight_engine.py``.  For a
block of B vertices: one gather ``X[:, idx] -> [N, B, K]``, one batched gram
``[B, K, K]``, batched SPD solves and batched prediction GEMMs; the score
family is row normalisations plus GEMMs over ``[B, n_test, D]`` predictions.

Null scoring keeps the JAX package's reformulation: a permutation of the
latent rows only permutes columns of the per-vertex cosine-distance matrix,
so each shuffle's accuracy is a gather from a rank-count tensor computed
once per block.

Layouts at the public functions are the JAX package's (``[N, B, K]``
patches, ``[B, K, D]`` weights, ``[B, M, D]`` predictions), so the tests
compare like with like.  The block steps are plain functions; PyTorch runs
them eagerly.  The four public steps are wrappers of one ``_block_step``,
and the three public score functions of one ``_score_families``.

Every CV fold scorer of the JAX package is here: ``"xla"``, ``"strict"``,
and the streamed-count scorers ``"pallas"``, ``"fused-pallas"`` and
``"fused-inv"`` (hand-written kernels in ``ops/hopper_metrics.py``) with
their dense twin ``"fused"``.

Precision: every function takes the JAX function's ``precision`` (the fit,
refit and prediction products) and, for the CV sweep, ``cv_precision`` and
``cv_dtype`` (the selection path only), with the TPU's meaning on every
device (``ops/precision.py``).  The defaults are the strict float32 path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.ops import precision as PR
from multimodal_decoding_tpu_torch.ops.ridge import first_argmax_with_tol, kfold_indices
from multimodal_decoding_tpu_torch.ops.solvers import spd_inverse, spd_solve
from multimodal_decoding_tpu_torch.utils.profiling import count, span

CV_SCORERS = ("xla", "strict", "pallas", "fused", "fused-pallas", "fused-inv")
_FUSED_SCORERS = ("fused", "fused-pallas", "fused-inv")
_STREAMED_FUSED = ("fused-pallas", "fused-inv")
NULL_GATHER_MODES = ("gather", "onehot", "onehot-bf16")

# DERANGEMENTS_THREE_DIMS of the reference (searchlight.py:35)
_DERANGEMENTS = ((1, 2, 0), (2, 0, 1))


# ---------------------------------------------------------------------------
# Fit + predict for one vertex block
# ---------------------------------------------------------------------------


def gather_patches(X: torch.Tensor, idx: torch.Tensor, mask=None) -> torch.Tensor:
    """X [N, V], idx [B, K] -> patches [N, B, K] (masked columns zeroed).

    Zeroing a column excludes that neighbour from the ridge fit exactly (its
    gram row/column vanish; the regulariser pins its weight to 0), which
    gives radius-mode neighbourhoods a static shape.

    16-bit betas whose K elements are not a whole number of 16 bytes are
    gathered, in one pass, into a buffer ``[N, B, Kp]`` with K rounded up to
    a multiple of 8 (its pad columns zeroed), and the ``[N, B, K]`` view of
    it is returned: every row, vertex and row-slice offset of the patches is
    then 16-byte aligned, which the card's bf16 GEMMs need to read them by
    tensor map.  Each such gather counts one ``mdt.engine.aligned_gather``.
    Float32 patches stay dense.
    """
    k = idx.shape[-1]
    kp = -(-k // 8) * 8
    if X.element_size() != 2 or kp == k:
        patches = X[:, idx.long()]
        if mask is not None:
            patches = patches * mask[None].to(patches.dtype)
        return patches
    count("mdt.engine.aligned_gather", 1)
    n, b = X.shape[0], idx.shape[0]
    idx_p = torch.zeros((b, kp), dtype=torch.long, device=idx.device)
    idx_p[:, :k] = idx
    buf = torch.empty((n, b, kp), dtype=X.dtype, device=X.device)
    torch.index_select(X, 1, idx_p.view(-1), out=buf.view(n, b * kp))
    buf[..., k:].zero_()
    patches = buf[..., :k]
    if mask is not None:
        patches.mul_(mask[None].to(patches.dtype))
    return patches


def _row_pitch(Xg: torch.Tensor) -> int:
    """The elements from one patch row to the next: K, or the padded width
    where ``Xg`` is a slice of ``gather_patches``' aligned buffer."""
    n, b, k = Xg.shape
    kp = Xg.stride(1)
    padded = Xg.stride(2) == 1 and kp > k and Xg.stride(0) == b * kp
    return kp if padded else k


def _gram(Xg: torch.Tensor, precision="highest") -> torch.Tensor:
    """[N, B, K] -> [B, K, K] = sum_n X[n, b, :]^T X[n, b, :], float32.

    On an aligned buffer over its ``Kp`` columns, whose pad rows and columns
    are dropped from the result (each entry kept sums the same products):
    both operands are contiguous along K, and cuBLAS vectorises their loads
    only as far as that extent divides, so at K = 750 itself it stays on
    2-element loads however the rows are aligned."""
    n, b, k = Xg.shape
    kp = _row_pitch(Xg)
    if kp > k:
        Xg = Xg.as_strided((n, b, kp), Xg.stride())
    Xb = Xg.permute(1, 0, 2)  # [B, N, K] view
    return PR.matmul(Xb.mT, Xb, precision)[:, :k, :k]


def _cross(Xg: torch.Tensor, Y: torch.Tensor, precision="highest") -> torch.Tensor:
    """[N, B, K], [N, D] -> [B, K, D] = sum_n X[n, b, :]^T Y[n, :], float32.

    One GEMM over the patch rows as they lie (reshaping an aligned buffer's
    strided view would copy it)."""
    n, b, k = Xg.shape
    kp = _row_pitch(Xg)
    rows = (Xg.reshape(n, b * k) if kp == k
            else Xg.as_strided((n, b * kp), (Xg.stride(0), 1)))
    return PR.matmul(rows.mT, Y, precision).reshape(b, kp, Y.shape[-1])[:, :k]


def fit_block(X_train_g: torch.Tensor, Y_train: torch.Tensor, alpha, precision="highest",
              solver: str = "cholesky") -> torch.Tensor:
    """Batched closed-form ridge over a vertex block: [N, B, K], [N, D] -> W [B, K, D]."""
    with span("mdt.engine.fit"):
        G = _gram(X_train_g, precision)
        XtY = _cross(X_train_g, Y_train, precision)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    with span("mdt.engine.solve"):
        return spd_solve(G + alpha * eye, XtY, method=solver, precision=precision)


def predict_block(X_query_g: torch.Tensor, W: torch.Tensor, precision="highest",
                  out_dtype=torch.float32) -> torch.Tensor:
    """X_query_g [M, B, K], W [B, K, D] -> preds [B, M, D] (``out_dtype``
    bfloat16: the bf16 product of bf16 operands)."""
    return PR.matmul(X_query_g.permute(1, 0, 2), W, precision, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Per-vertex CV alpha sweep
# ---------------------------------------------------------------------------


def fit_block_cv(
    X_train_g: torch.Tensor,
    Y_train: torch.Tensor,
    alphas: torch.Tensor,
    n_splits: int = 5,
    precision="highest",
    solver: str = "cholesky",
    cv_precision=None,
    cv_solver: str | None = None,
    cv_scorer: str = "xla",
    cv_dtype=None,
    cv_alpha_batch: bool | int = False,
):
    """Per-vertex alpha selection via K-fold CV (sklearn-split parity).

    Returns ``(W [B, K, D]`` refit at each vertex's best alpha,
    ``best_alpha [B]``, ``cv_scores [B, n_alphas])``.  Fold grams are the
    full gram minus the validation rows' gram, so the 5-fold sweep costs ~2
    gram passes instead of 5; contiguous folds are slices, not gathers.

    ``cv_precision``, ``cv_solver`` and ``cv_dtype`` apply only to the
    alpha-selection path (fold grams, per-alpha solves, validation
    predictions and scoring); the refit keeps ``precision``/``solver``.
    ``None`` inherits the strict settings.  ``cv_dtype`` (``torch.bfloat16``)
    stores the selection operands (the per-fold patch slices, never the
    whole patch tensor, the targets, the per-alpha weights and the
    predictions) in that dtype, with float32 sums; the refit never touches
    them.

    ``cv_scorer``: "xla" is the scale-invariant fold scorer (unnormalised
    predictions against unit latent rows); "strict" materialises
    cosine-distance matrices like the final metrics; "pallas" counts the
    same comparisons as "xla" with the streamed kernel
    (``HM.streamed_pairwise_acc``).  The "fused*" scorers reassociate
    ``sim = Xv W Yv_n^T`` through K: ``U = XtY_tr Yv_n^T`` once per fold,
    ``inv = (G_tr + a I)^-1`` per alpha, ``sim = Xv (inv U)``, with no
    ``[B, nv, D]`` predictions: "fused" forms ``sim`` densely,
    "fused-pallas" streams it from ``Z = inv U``
    (``HM.streamed_acc_from_factors``; at "default"/"high" Z comes as bf16
    planes from ``HM.factor_planes``) and "fused-inv" forms ``Z`` inside the
    kernel's call too (``HM.streamed_acc_from_inv``, the same Z GEMM).

    ``cv_alpha_batch`` (``True`` or a chunk that divides the alpha count;
    "xla" scorer only) inverts ``chunk`` alpha-shifted systems in one
    ``spd_inverse`` call over ``[chunk * B, K, K]``.  The JAX package's
    ``cv_unroll`` has no counterpart: it unrolls a ``lax.map`` over alphas,
    and the eager sweep here already issues the alphas one after another.
    """
    if cv_scorer not in CV_SCORERS:
        raise ValueError(f"unknown cv_scorer {cv_scorer!r}; use one of {CV_SCORERS}")
    if cv_alpha_batch and cv_scorer != "xla":
        # the alpha-batched sweep implements only the xla fold scorer
        raise ValueError(f"cv_alpha_batch requires cv_scorer='xla'; got {cv_scorer!r}")
    cv_precision = precision if cv_precision is None else cv_precision
    cv_solver = solver if cv_solver is None else cv_solver
    n = X_train_g.shape[0]
    k = X_train_g.shape[-1]
    folds = kfold_indices(n, n_splits)
    Y_sel = Y_train if cv_dtype is None else Y_train.to(cv_dtype)
    pred_dtype = torch.float32 if cv_dtype is None else cv_dtype

    def k_by_nv(x, y):
        """x @ y [B, K, nv] at cv_precision; for the streamed kernels into
        rows that start 16 bytes apart, which they copy 16 bytes at a time."""
        out = (None if cv_scorer == "fused"
               else HM.padded_empty(x.shape[0], k, y.shape[-1], x.device))
        return PR.matmul(x, y, cv_precision, out=out)

    def fold_scores(val_idx: np.ndarray) -> torch.Tensor:
        lo, hi = int(val_idx[0]), int(val_idx[-1]) + 1  # KFold folds are contiguous
        Xv, Yv, Yv_sel = X_train_g[lo:hi], Y_train[lo:hi], Y_sel[lo:hi]
        if cv_dtype is not None:  # the fold's slice only
            # the streamed fused scorers' patches in rows of a multiple of 64
            # elements: their tensor-core kernels then load Xv_b by tensor map
            Xv = (HM.padded_copy(Xv, cv_dtype) if cv_scorer in _STREAMED_FUSED
                  else Xv.to(cv_dtype))
        Yv_n = Yv / torch.linalg.vector_norm(Yv, dim=-1, keepdim=True)
        Yv_n_sel = Yv_n if cv_dtype is None else Yv_n.to(cv_dtype)
        G_tr = G_full - _gram(Xv, cv_precision)
        XtY_tr = XtY_full - _cross(Xv, Yv_sel, cv_precision)
        if cv_scorer in _FUSED_SCORERS:
            U = k_by_nv(XtY_tr, Yv_n_sel.mT)  # [B, K, nv], once per fold
            Xv_b = Xv.permute(1, 0, 2)  # [B, nv, K] view, once per fold
            out = []
            for a in range(alphas.shape[0]):
                inv = spd_inverse(G_tr + alphas[a] * eye, method=cv_solver,
                                  precision=cv_precision)
                if cv_scorer == "fused-inv":
                    out.append(HM.streamed_acc_from_inv(Xv_b, inv, U, cv_precision))
                    continue
                if cv_scorer == "fused-pallas" and PR.resolve(cv_precision) != "highest":
                    # Z's bf16 planes [P, B, K, nv] from its producer, the
                    # GEMM fused-inv forms it with: the count reads them as
                    # they are
                    Z = HM.factor_planes(inv, U, cv_precision)
                else:
                    Z = k_by_nv(inv, U)  # [B, K, nv]
                if cv_scorer == "fused-pallas":
                    out.append(HM.streamed_acc_from_factors(Xv_b, Z, cv_precision))
                else:
                    out.append(M.pairwise_acc_from_sim(PR.matmul(Xv_b, Z, cv_precision)))
            return torch.stack(out)  # [A, B]

        def score(W):
            W_sel = W if cv_dtype is None else W.to(cv_dtype)
            preds = predict_block(Xv, W_sel, cv_precision, out_dtype=pred_dtype)  # [B, nv, D]
            if cv_scorer == "xla":
                return M.pairwise_acc_scale_invariant(preds, Yv_n_sel, cv_precision)
            if cv_scorer == "pallas":
                return HM.streamed_pairwise_acc(preds, Yv, cv_precision)
            return M.pairwise_acc_from_dist(M.cosine_distances(preds, Yv, cv_precision))

        if cv_alpha_batch:
            a_cnt = alphas.shape[0]
            chunk = a_cnt if cv_alpha_batch is True else int(cv_alpha_batch)
            if a_cnt % chunk:
                raise ValueError(f"cv_alpha_batch={chunk} must divide n_alphas={a_cnt}")
            out = []
            for c0 in range(0, a_cnt, chunk):
                A_all = G_tr[None] + alphas[c0:c0 + chunk, None, None, None] * eye
                inv_all = spd_inverse(A_all.reshape((-1,) + tuple(G_tr.shape[1:])),
                                      method=cv_solver, precision=cv_precision)
                for inv in inv_all.reshape(A_all.shape):
                    out.append(score(PR.matmul(inv, XtY_tr, cv_precision)))
            return torch.stack(out)  # [A, B]
        return torch.stack([
            score(spd_solve(G_tr + alphas[a] * eye, XtY_tr, method=cv_solver,
                            precision=cv_precision, apply_dtype=cv_dtype))
            for a in range(alphas.shape[0])])  # [A, B]

    with span("mdt.engine.select"):
        # the full gram and cross, which fold_scores and the refit share
        with span("mdt.engine.fit"):
            G_full = _gram(X_train_g, precision)
            XtY_full = _cross(X_train_g, Y_train, precision)
        eye = torch.eye(k, dtype=G_full.dtype, device=G_full.device)
        # the fold mean as XLA computes it: a sum times the reciprocal count
        scores = M.count_ratio(torch.stack([fold_scores(v) for _, v in folds]).sum(dim=0),
                               len(folds))  # [A, B]
        best = first_argmax_with_tol(scores, axis=0)  # [B]
        best_alpha = alphas[best]
    with span("mdt.engine.solve"):
        W = spd_solve(G_full + best_alpha[:, None, None] * eye, XtY_full, method=solver,
                      precision=precision)
    return W, best_alpha, scores.T


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TestLayout:
    """Static index layout of the test set.

    ``caption_sel``/``image_sel``: positions in the prediction rows (X
    order); the latent rows follow the same stim_types array.
    """

    caption_sel: tuple
    image_sel: tuple

    @staticmethod
    def from_stim_types(stim_types, caption="caption", image="image") -> "TestLayout":
        st = np.asarray(stim_types)
        return TestLayout(
            caption_sel=tuple(np.where(st == caption)[0].tolist()),
            image_sel=tuple(np.where(st == image)[0].tolist()),
        )


# number of metric families null_score_block emits: captions, images, and
# the two imagery variants each with a _no_std twin.  The runner sizes its
# flush budget from this.
N_NULL_METRICS = 6


@dataclass(frozen=True)
class ScoreConstants:
    """The score family's index tensors on its device: the caption and
    image rows of the test set, the two imagery derangements [2, 3] and,
    with nulls, the shuffles restricted to each modality's rows as local
    indices [P, n].  None of them depends on a block, so a run builds them
    once (``score_constants``) and hands them to every block step."""

    caption: torch.Tensor
    image: torch.Tensor
    derangements: torch.Tensor
    local_caption: torch.Tensor | None = None
    local_image: torch.Tensor | None = None


def score_constants(layout: TestLayout, device, shuffles: torch.Tensor | None = None
                    ) -> ScoreConstants:
    """``layout``'s selectors, the derangement table and, given the [P,
    n_test] ``shuffles`` (on ``device``), each modality's local shuffles."""
    cap, img = (torch.as_tensor(sel, dtype=torch.long, device=device)
                for sel in (layout.caption_sel, layout.image_sel))
    der = torch.as_tensor(_DERANGEMENTS, dtype=torch.long, device=device)
    if shuffles is None:
        return ScoreConstants(cap, img, der)
    n_test = shuffles.shape[-1]
    return ScoreConstants(cap, img, der, _local_shuffles(shuffles, cap, n_test),
                          _local_shuffles(shuffles, img, n_test))


def _rank_counts(dist: torch.Tensor) -> torch.Tensor:
    """C[..., i, c] = #{c': dist[..., i, c] < dist[..., i, c']}.

    Any column-permuted accuracy is the mean of C at the permuted diagonal.
    """
    return torch.sum(dist[..., :, None] < dist[..., None, :], dim=-1)


def _gather_perm_diag(C: torch.Tensor, perm: torch.Tensor,
                      mode: str = "gather") -> torch.Tensor:
    """Permuted-diagonal pick: out[b, p, i] = C[b, i, perm[(b,) p, i]].

    For the shared 2-D [P, n] shuffles, ``mode`` picks the formulation:
    "gather" (advanced indexing), "onehot" (one-hot @ counts, float32,
    exact) or "onehot-bf16" (bf16 operands; exact while rank counts stay
    below 256, so m > 256 falls back to "onehot").  Per-(b, p, i) picks
    (perm.ndim == 3) always gather.
    """
    if mode not in NULL_GATHER_MODES:
        raise ValueError(f"unknown null-gather mode {mode!r} "
                         "(expected 'gather', 'onehot', or 'onehot-bf16')")
    perm = perm.long()
    if perm.ndim == 2 and mode != "gather":
        if mode == "onehot-bf16" and C.shape[-1] > 256:
            # bf16 holds integers exactly only up to 256; counts reach m-1
            mode = "onehot"
        dt = torch.bfloat16 if mode == "onehot-bf16" else torch.float32
        E = torch.eye(C.shape[-1], dtype=dt, device=C.device)[perm]  # [P, n, m]
        # each output sums one nonzero product, so the bf16 result is exact
        return torch.einsum("bim,pim->bpi", C.to(dt), E).to(torch.float32)
    if perm.ndim == 2:
        perm = perm[None].expand((C.shape[0],) + tuple(perm.shape))
    b_idx = torch.arange(C.shape[0], device=C.device)[:, None, None]
    i_idx = torch.arange(C.shape[1], device=C.device)[None, None, :]
    return C[b_idx, i_idx, perm]


def _local_shuffles(shuffles: torch.Tensor, sel: torch.Tensor, n_test: int) -> torch.Tensor:
    """Shuffles [P, n_test] restricted to the rows ``sel`` as local indices [P, n]."""
    inv = torch.zeros((n_test,), dtype=torch.long, device=shuffles.device)
    inv[sel] = torch.arange(len(sel), device=shuffles.device)
    return inv[shuffles.long()[:, sel]]


def _score_families(preds_test, preds_imag, Y_test, Y_imag, layout: TestLayout,
                    comp_cross: bool = True, null=None, constants: ScoreConstants | None = None
                    ) -> tuple:
    """The main score family and, with ``null = (shuffles,
    imagery_derangements, null_gather)``, the null family -> ``(main, null
    or None)``.

    Each family's cosine distances are formed once.  With nulls, its main
    accuracy is the rank counts' diagonal (the identity permutation's
    gather), so one C serves both outputs; without, it is
    ``M.pairwise_acc_from_dist``, the same comparisons without C.  Keys:
    main in ``score_block``'s order, null in ``null_score_block``'s.

    ``constants``: ``score_constants(layout, device, shuffles)``, built by
    the caller once for many blocks; None builds them here.  Built once,
    they leave the family no host-to-device copy.
    """
    if null is not None:
        shuffles, imagery_derangements, null_gather = null
        if preds_imag.shape[-2] != 3:
            raise ValueError(
                "null scoring uses the reference's 3-element imagery derangements "
                f"(searchlight.py:35); got {preds_imag.shape[-2]} imagery stimuli")
    if constants is None:
        constants = score_constants(layout, preds_test.device,
                                    None if null is None else shuffles)
    elif null is not None and constants.local_caption is None:
        raise ValueError("null scoring needs constants built with the shuffles")
    cap, img = constants.caption, constants.image
    # [B, P] choices of one of the two 3-element derangements -> [B, P, 3]
    der_idx = None if null is None else constants.derangements[imagery_derangements.long()]
    main, nulls = {}, None if null is None else {}

    def family(name, P, L, perm=None):
        """``name``'s main accuracy of P against L, and its nulls where
        ``perm`` gives the permuted columns."""
        dist = M.cosine_distances(P, L)
        if nulls is None or perm is None:
            main[name] = M.pairwise_acc_from_dist(dist)
            return
        n, m = dist.shape[-2:]
        C = _rank_counts(dist)
        diag = torch.diagonal(C, dim1=-2, dim2=-1)
        main[name] = M.count_ratio(torch.sum(diag, dim=-1), n * m - min(n, m))
        nulls[name] = M.count_ratio(
            torch.sum(_gather_perm_diag(C, perm, null_gather), dim=-1), n * m - n)

    P_cap = M.standardize(preds_test[:, cap, :])
    P_img = M.standardize(preds_test[:, img, :])
    L_cap = Y_test[cap]
    L_img = Y_test[img]
    family(M.ACC_CAPTIONS, P_cap, L_cap, constants.local_caption)
    family(M.ACC_IMAGES, P_img, L_img, constants.local_image)
    if comp_cross:
        family(M.ACC_CROSS_CAPTIONS_TO_IMAGES, P_cap, L_img)
        family(M.ACC_CROSS_IMAGES_TO_CAPTIONS, P_img, L_cap)
    L_whole = torch.cat((Y_imag, Y_test), dim=0)
    for suffix, P_im in (("", M.standardize(preds_imag)), ("_no_std", preds_imag)):
        family(M.ACC_IMAGERY + suffix, P_im, Y_imag, der_idx)
        family(M.ACC_IMAGERY_WHOLE_TEST + suffix, P_im, L_whole, der_idx)
    return main, nulls


def score_block(
    preds_test: torch.Tensor,
    preds_imag: torch.Tensor,
    Y_test: torch.Tensor,
    Y_imag: torch.Tensor,
    layout: TestLayout,
    comp_cross_decoding_scores: bool = True,
) -> dict:
    """Full main score family for a vertex block -> {metric: [B]}.

    calc_all_pairwise_accuracy_scores(standardize_predictions=True) plus
    the *_no_std imagery variants (reference searchlight.py:81-88).
    """
    return _score_families(preds_test, preds_imag, Y_test, Y_imag, layout,
                           comp_cross_decoding_scores)[0]


def null_score_block(
    preds_test: torch.Tensor,
    preds_imag: torch.Tensor,
    Y_test: torch.Tensor,
    Y_imag: torch.Tensor,
    layout: TestLayout,
    shuffles: torch.Tensor,
    imagery_derangements: torch.Tensor,
    null_gather: str = "gather",
) -> dict:
    """Null-distribution score family for every shuffle -> {metric: [B, P]}.

    ``shuffles`` [P, n_test] permutes test latent rows within modality;
    ``imagery_derangements`` [B, P] selects one of the two 3-element
    derangements per (vertex, shuffle) (reference searchlight.py:61-79).
    """
    return _score_families(preds_test, preds_imag, Y_test, Y_imag, layout, False,
                           (shuffles, imagery_derangements, null_gather))[1]


def score_and_null_block(
    preds_test: torch.Tensor,
    preds_imag: torch.Tensor,
    Y_test: torch.Tensor,
    Y_imag: torch.Tensor,
    layout: TestLayout,
    shuffles: torch.Tensor,
    imagery_derangements: torch.Tensor,
    comp_cross_decoding_scores: bool = True,
    null_gather: str = "gather",
) -> tuple:
    """Main + null score families sharing the distance/rank-count tensors:
    ``(score_block``'s dict, ``null_score_block``'s dict)."""
    return _score_families(preds_test, preds_imag, Y_test, Y_imag, layout,
                           comp_cross_decoding_scores,
                           (shuffles, imagery_derangements, null_gather))


# ---------------------------------------------------------------------------
# Block steps
# ---------------------------------------------------------------------------


def _split_patches(X_all, idx, mask, n_train, n_test):
    with span("mdt.engine.gather"):
        patches = gather_patches(X_all, idx, mask)  # [N_all, B, K]
    return patches[:n_train], patches[n_train:n_train + n_test], patches[n_train + n_test:]


def _block_step(X_all, Y_train, Y_test, Y_imag, idx, mask, alpha, null, *, layout, n_train,
                n_test, comp_cross, precision, solver, cv=None, constants=None):
    """The block step behind the four public ones: gather -> fit -> predict
    -> score, inside ``mdt.engine.step``.

    ``alpha`` is the fixed alpha, or with ``cv`` (``fit_block_cv``'s
    selection arguments) the CV grid; ``null`` is ``(shuffles,
    imagery_derangements, null_gather)`` or None; ``constants`` the
    score's (``score_constants``), or None to build them in the step.
    Returns ``(main, null or None)``, with ``best_alpha`` among the main
    maps under CV.
    """
    with span("mdt.engine.step"):
        Xtr, Xte, Xim = _split_patches(X_all, idx, mask, n_train, n_test)
        if cv is None:
            W = fit_block(Xtr, Y_train, alpha, precision=precision, solver=solver)
        else:
            W, best_alpha, _ = fit_block_cv(Xtr, Y_train, alpha, precision=precision,
                                            solver=solver, **cv)
        with span("mdt.engine.score"):
            main, nulls = _score_families(predict_block(Xte, W, precision),
                                          predict_block(Xim, W, precision), Y_test, Y_imag,
                                          layout, comp_cross, null, constants)
    if cv is not None:
        main["best_alpha"] = best_alpha
    return main, nulls


def searchlight_block(X_all, Y_train, Y_test, Y_imag, idx, mask, alpha, *,
                      layout: TestLayout, n_train: int, n_test: int,
                      comp_cross: bool = True, precision="highest",
                      solver: str = "cholesky", constants: ScoreConstants | None = None):
    """One block step: gather -> fit -> predict -> score.  Returns {metric: [B]}.

    X_all [N_all, V] = concat(train, test, imagery) rows (float32, or bf16
    storage under fast math); idx [B, K]; mask [B, K] or None.  Every step
    takes ``constants``, the score's ``score_constants`` for ``layout`` (and
    the shuffles), which a caller running many blocks builds once.
    """
    return _block_step(X_all, Y_train, Y_test, Y_imag, idx, mask, alpha, None, layout=layout,
                       n_train=n_train, n_test=n_test, comp_cross=comp_cross,
                       precision=precision, solver=solver, constants=constants)[0]


def searchlight_block_with_null(X_all, Y_train, Y_test, Y_imag, idx, mask, alpha,
                                shuffles, imagery_derangements, *,
                                layout: TestLayout, n_train: int, n_test: int,
                                comp_cross: bool = True, precision="highest",
                                solver: str = "cholesky", null_gather: str = "gather",
                                constants: ScoreConstants | None = None):
    """Block step that also emits the per-shuffle null score family."""
    return _block_step(X_all, Y_train, Y_test, Y_imag, idx, mask, alpha,
                       (shuffles, imagery_derangements, null_gather), layout=layout,
                       n_train=n_train, n_test=n_test, comp_cross=comp_cross,
                       precision=precision, solver=solver, constants=constants)


def searchlight_block_cv_with_null(X_all, Y_train, Y_test, Y_imag, idx, mask, alphas,
                                   shuffles, imagery_derangements, *,
                                   layout: TestLayout, n_train: int, n_test: int,
                                   n_splits: int = 5, comp_cross: bool = True,
                                   precision="highest", solver: str = "cholesky",
                                   cv_precision=None, cv_solver: str | None = None,
                                   cv_scorer: str = "xla", cv_dtype=None,
                                   cv_alpha_batch: bool = False,
                                   null_gather: str = "gather",
                                   constants: ScoreConstants | None = None):
    """CV block step that also emits the per-shuffle null score family.

    The main path: each vertex's null scores come from the decoder refit at
    that vertex's CV-selected alpha.
    """
    cv = dict(n_splits=n_splits, cv_precision=cv_precision, cv_solver=cv_solver,
              cv_scorer=cv_scorer, cv_dtype=cv_dtype, cv_alpha_batch=cv_alpha_batch)
    return _block_step(X_all, Y_train, Y_test, Y_imag, idx, mask, alphas,
                       (shuffles, imagery_derangements, null_gather), layout=layout,
                       n_train=n_train, n_test=n_test, comp_cross=comp_cross,
                       precision=precision, solver=solver, cv=cv,
                       constants=constants)


def searchlight_block_cv(X_all, Y_train, Y_test, Y_imag, idx, mask, alphas, *,
                         layout: TestLayout, n_train: int, n_test: int,
                         n_splits: int = 5, comp_cross: bool = True,
                         precision="highest", solver: str = "cholesky",
                         cv_precision=None, cv_solver: str | None = None,
                         cv_scorer: str = "xla", cv_dtype=None,
                         cv_alpha_batch: bool = False,
                         constants: ScoreConstants | None = None):
    """Block step with per-vertex CV alpha selection."""
    cv = dict(n_splits=n_splits, cv_precision=cv_precision, cv_solver=cv_solver,
              cv_scorer=cv_scorer, cv_dtype=cv_dtype, cv_alpha_batch=cv_alpha_batch)
    return _block_step(X_all, Y_train, Y_test, Y_imag, idx, mask, alphas, None, layout=layout,
                       n_train=n_train, n_test=n_test, comp_cross=comp_cross,
                       precision=precision, solver=solver, cv=cv,
                       constants=constants)[0]
