"""Closed-form ridge regression: primal and dual forms, alpha sweep and CV.

Port of ``multimodal_decoding_tpu/ops/ridge.py``:

* **Dual (kernel) form** for wide problems (the whole-brain decode: ~8k
  stimuli x up to ~327k vertices): the gram ``K = X X^T`` is accumulated over
  column blocks streamed from a host array (``gram_matrix``), then every
  (fold, alpha) fit is an ``[n, n]`` solve.  Predictions never form the
  ``[V, D]`` weights: ``pred(Xq) = (Xq X^T) dual_coef``.
* **Primal form** for tall problems (``ridge_fit_primal``).

CV reproduces sklearn's ``KFold(shuffle=False)`` folds and GridSearchCV's
first-argmax up to the tie band of ``first_argmax_with_tol``.  With
``cv_solver`` set, the selection inverts each fold's ``[A, n_tr, n_tr]``
systems in one batched ``ops/solvers.spd_inverse`` call (``"schur-pallas"``:
the Schur recursion whose base blocks launch the panel kernel); the refit is
always the strict Cholesky solve.

Every product runs in float32 with TF32 off (``device.py``).  Each function
takes ``device`` (``None``: cuda, which raises without a GPU).  The kernels
take a feature ``mesh`` (``parallel/mesh.feature_mesh``, the JAX package's
tensor-parallel gram): each rank streams only its column range of the host
betas and one all_reduce sums the partial kernels.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_decoding_tpu_torch.device import as_float32, resolve_device, synchronize
from multimodal_decoding_tpu_torch.ops import precision as PR
from multimodal_decoding_tpu_torch.ops.metrics import pairwise_accuracy
from multimodal_decoding_tpu_torch.ops.solvers import spd_inverse
from multimodal_decoding_tpu_torch.parallel.multihost import host_shard_bounds
from multimodal_decoding_tpu_torch.utils.profiling import count, span

#: Width of the alpha-selection tie band (see first_argmax_with_tol).
ALPHA_TIE_TOL = 1e-6


def first_argmax_with_tol(scores: torch.Tensor, axis: int = 0,
                          tol: float = ALPHA_TIE_TOL) -> torch.Tensor:
    """First index whose score is within ``tol`` of the max along ``axis``.

    Exact ties go to the FIRST index, like sklearn GridSearchCV's
    ``np.argmax``; scores within ``tol`` of the max count as tied, so float32
    rounding cannot decide between alphas that float64 would call equal.
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does.
    """
    mx = torch.amax(scores, dim=axis, keepdim=True)
    return torch.argmax((scores >= mx - tol).to(torch.uint8), dim=axis)


def kfold_indices(n_samples: int, n_splits: int):
    """Consecutive-block K-fold split, sklearn ``KFold(shuffle=False)`` parity.

    First ``n_samples % n_splits`` folds have size ``n//k + 1``; returns a
    list of (train_idx, val_idx) numpy arrays.
    """
    indices = np.arange(n_samples)
    fold_sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    fold_sizes[: n_samples % n_splits] += 1
    folds = []
    current = 0
    for size in fold_sizes:
        val = indices[current : current + size]
        train = np.concatenate([indices[:current], indices[current + size :]])
        folds.append((train, val))
        current += size
    return folds


# ---------------------------------------------------------------------------
# Primal form: small feature dim
# ---------------------------------------------------------------------------


def ridge_fit_primal(X, Y, alpha, device=None) -> torch.Tensor:
    """W = (X^T X + alpha I)^-1 X^T Y.  X [..., n, f], Y [..., n, d] -> W [..., f, d]."""
    device = resolve_device(device)
    X, Y = as_float32(X, device), as_float32(Y, device)
    A = X.mT @ X + alpha * torch.eye(X.shape[-1], dtype=X.dtype, device=device)
    return torch.cholesky_solve(X.mT @ Y, torch.linalg.cholesky(A))


def ridge_predict(X, W, device=None) -> torch.Tensor:
    device = resolve_device(device)
    return as_float32(X, device) @ as_float32(W, device)


# ---------------------------------------------------------------------------
# Dual form: wide problems (whole-brain)
# ---------------------------------------------------------------------------


class _ColumnBlocks:
    """Column blocks ``X[:, lo:hi]`` of host arrays, each uploaded to ``device``.

    On CUDA each block is copied into one of two pinned host buffers (span
    ``mdt.gram.stage``) and sent asynchronously on the current stream
    (``mdt.gram.h2d``, its bytes counted in ``mdt.gram.h2d_bytes``), so the
    host copy of the next block overlaps the transfer and products of this
    one; a buffer is refilled only after the event of its last transfer.  On
    the CPU the block is a view.
    """

    def __init__(self, arrays: list, block_cols: int, device: torch.device):
        self.hosts = [torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in arrays]
        self.block_cols, self.device = block_cols, device
        if device.type == "cuda":
            self.pinned = [[torch.empty(h.shape[0] * block_cols, dtype=torch.float32,
                                        pin_memory=True) for h in self.hosts]
                           for _ in range(2)]
            self.done = [None, None]

    def __iter__(self):
        f = self.hosts[0].shape[1]
        for i, lo in enumerate(range(0, f, self.block_cols)):
            hi = min(lo + self.block_cols, f)
            if self.device.type != "cuda":
                yield [h[:, lo:hi] for h in self.hosts]
                continue
            slot = i % 2
            with span("mdt.gram.stage"):
                if self.done[slot] is not None:
                    self.done[slot].synchronize()
                staged = [buf[:h.shape[0] * (hi - lo)].view(h.shape[0], hi - lo)
                          for h, buf in zip(self.hosts, self.pinned[slot])]
                for h, buf in zip(self.hosts, staged):
                    buf.copy_(h[:, lo:hi])
            with span("mdt.gram.h2d"):
                blocks = [s.to(self.device, non_blocking=True) for s in staged]
                self.done[slot] = torch.cuda.Event()
                self.done[slot].record()
            count("mdt.gram.h2d_bytes", sum(s.nbytes for s in staged))
            yield blocks


def streamed_kernels(X_train: np.ndarray, queries=(), block_cols: int = 16384,
                     with_gram: bool = True, mesh=None, device=None):
    """``K = X X^T`` and ``Xq X^T`` for each query, in one pass over X's columns.

    Each column block of ``X_train`` crosses to the device once and feeds the
    gram and every query kernel.  With a feature ``mesh`` this rank streams
    only its columns ``host_shard_bounds(f, rank, W)`` (any f: the ranges may
    differ by one column), and one all_reduce per kernel sums the ranks'
    partial products, so every rank returns the whole kernels.  Returns
    ``(K or None, [Kq, ...])``.
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    arrays = [X_train, *queries]
    if mesh is not None:
        lo, hi = host_shard_bounds(X_train.shape[1], mesh.rank, mesh.size)
        arrays = [np.asarray(a)[:, lo:hi] for a in arrays]
    n = X_train.shape[0]
    K = torch.zeros((n, n), dtype=torch.float32, device=device) if with_gram else None
    Kq = [torch.zeros((q.shape[0], n), dtype=torch.float32, device=device) for q in queries]
    for xt, *xqs in _ColumnBlocks(arrays, block_cols, device):
        with span("mdt.gram.products"):
            if with_gram:
                K.addmm_(xt, xt.mT)
            for k, xq in zip(Kq, xqs):
                k.addmm_(xq, xt.mT)
    if mesh is not None:
        for k in [K, *Kq] if with_gram else Kq:
            dist.all_reduce(k)
    return K, Kq


def gram_matrix(X: np.ndarray, block_cols: int = 16384, mesh=None, device=None) -> torch.Tensor:
    """K = X X^T streamed over column blocks (host -> device), strict float32.

    The full X (e.g. [8k, 327k] float32, ~11 GB) need not fit on the device:
    each block is transferred, multiplied and accumulated.  ``mesh``: see
    ``streamed_kernels``.
    """
    return streamed_kernels(X, (), block_cols, mesh=mesh, device=device)[0]


def cross_matrix(X_query: np.ndarray, X_train: np.ndarray, block_cols: int = 16384,
                 mesh=None, device=None) -> torch.Tensor:
    """K_query = Xq X^T streamed over column blocks."""
    return streamed_kernels(X_train, (X_query,), block_cols, with_gram=False, mesh=mesh,
                            device=device)[1][0]


def dual_ridge_fit(K, Y, alpha, device=None) -> torch.Tensor:
    """dual_coef = (K + alpha I)^-1 Y by a Cholesky solve;  K [n, n], Y [n, d]."""
    device = resolve_device(device)
    K, Y = as_float32(K, device), as_float32(Y, device)
    A = K + alpha * torch.eye(K.shape[-1], dtype=K.dtype, device=device)
    return torch.cholesky_solve(Y, torch.linalg.cholesky(A))


def dual_ridge_predict(K_query, dual_coef, device=None) -> torch.Tensor:
    """pred = (Xq X^T) dual_coef;  K_query [m, n]."""
    device = resolve_device(device)
    return as_float32(K_query, device) @ as_float32(dual_coef, device)


# ---------------------------------------------------------------------------
# CV alpha sweep (GridSearchCV parity)
# ---------------------------------------------------------------------------


def _cv_fold_scores(K_tt, K_vt, Y_tr, Y_va, alphas, scorer=None, solver=None,
                    precision="highest"):
    """Scores for all ``alphas`` (floats) on one fold, ``[n_alphas]``.

    ``solver=None`` (strict): a Cholesky solve per alpha, one alpha at a
    time.  A solver name inverts all ``[A, n_tr, n_tr]`` systems in one
    batched ``spd_inverse`` call, then applies each inverse with two GEMMs,
    all at ``precision``; selection grade only, the refit in
    ``ridge_cv_dual`` never changes.
    """
    score = pairwise_accuracy if scorer is None else scorer
    device = K_tt.device
    if solver is None:
        return torch.stack([score(Y_va, K_vt @ dual_ridge_fit(K_tt, Y_tr, a, device=device))
                            for a in alphas])
    eye = torch.eye(K_tt.shape[-1], dtype=K_tt.dtype, device=device)
    a = torch.as_tensor(alphas, dtype=torch.float32, device=device)
    inv_all = spd_inverse(K_tt[None] + a[:, None, None] * eye, method=solver,
                          precision=precision)
    return torch.stack([
        score(Y_va, PR.matmul(K_vt, PR.matmul(inv, Y_tr, precision), precision))
        for inv in inv_all])


def _cv_fold_scores_sliced(K, Y, lo: int, hi: int, alphas, scorer=None, solver=None,
                           precision="highest"):
    """_cv_fold_scores on the fold ``[lo, hi)``, its blocks assembled from slices.

    KFold validation folds are contiguous ranges, so the train blocks are
    2 x 2 slice concatenations of the full gram: no index gather.
    """
    K_tt = torch.cat([torch.cat([K[:lo, :lo], K[:lo, hi:]], dim=1),
                      torch.cat([K[hi:, :lo], K[hi:, hi:]], dim=1)], dim=0)
    K_vt = torch.cat([K[lo:hi, :lo], K[lo:hi, hi:]], dim=1)
    Y_tr = torch.cat([Y[:lo], Y[hi:]], dim=0)
    return _cv_fold_scores(K_tt, K_vt, Y_tr, Y[lo:hi], alphas, scorer=scorer, solver=solver,
                           precision=precision)


def ridge_cv_dual(
    K,
    Y,
    alphas: Sequence[float],
    n_splits: int = 5,
    scorer: Callable | None = None,
    cv_solver: str | None = None,
    device=None,
    timings: dict | None = None,
    cv_precision=None,
):
    """GridSearchCV(Ridge, scoring=pairwise_accuracy, cv=KFold) on the gram.

    Returns (best_alpha_idx, mean_scores [n_alphas] numpy, full-train
    dual_coef for the best alpha, a tensor on ``device``).  sklearn
    semantics: unshuffled consecutive folds, unweighted mean of fold scores,
    refit on the full train set; the tie-break is ``first_argmax_with_tol``.
    ``cv_solver``: the selection solver (see _cv_fold_scores), whose
    products run at ``cv_precision`` (``None``: the shipped
    ``precision.default_cv_precision(device)``); the refit is always the
    strict Cholesky solve.  ``timings``: if a dict, its
    ``cv_s`` and ``refit_s`` get the seconds of the two stages (spans
    ``mdt.ridge.select`` and ``mdt.ridge.refit``), each ended by a device
    synchronisation.  ``K`` is the whole gram (replicated under
    a feature mesh): there is nothing to shard here.
    """
    device = resolve_device(device)
    if cv_precision is None:
        cv_precision = PR.default_cv_precision(device)
    t0 = time.perf_counter()
    with span("mdt.ridge.select"):
        K, Y = as_float32(K, device), as_float32(Y, device)
        alphas = [float(a) for a in alphas]
        fold_scores = []
        for train_idx, val_idx in kfold_indices(K.shape[0], n_splits):
            lo, hi = int(val_idx[0]), int(val_idx[-1]) + 1
            if np.array_equal(val_idx, np.arange(lo, hi)):
                fold_scores.append(_cv_fold_scores_sliced(K, Y, lo, hi, alphas, scorer=scorer,
                                                          solver=cv_solver,
                                                          precision=cv_precision))
            else:
                # gather fallback for non-contiguous folds (a bare assert would
                # vanish under python -O and silently slice wrong rows)
                tr = torch.as_tensor(np.ascontiguousarray(train_idx), device=device)
                va = torch.as_tensor(np.ascontiguousarray(val_idx), device=device)
                fold_scores.append(_cv_fold_scores(K[tr][:, tr], K[va][:, tr], Y[tr], Y[va],
                                                   alphas, scorer=scorer, solver=cv_solver,
                                                   precision=cv_precision))
        mean_scores = torch.mean(torch.stack(fold_scores), dim=0)
        best_idx = int(first_argmax_with_tol(mean_scores))
        mean_scores = mean_scores.cpu().numpy()
    t1 = time.perf_counter()
    with span("mdt.ridge.refit"):
        dual_coef = dual_ridge_fit(K, Y, alphas[best_idx], device=device)
    if timings is not None:
        synchronize(device)
        timings.update(cv_s=t1 - t0, refit_s=time.perf_counter() - t1)
    return best_idx, mean_scores, dual_coef


# ---------------------------------------------------------------------------
# Batched multi-alpha spectral sweep (for dense alpha grids on one gram)
# ---------------------------------------------------------------------------


def dual_ridge_fit_all_alphas_eigh(K, Y, alphas, device=None) -> torch.Tensor:
    """All-alphas dual coefficients via one eigendecomposition.

    eigh(K) = U diag(lam) U^T; dual(alpha) = U diag(1/(lam+alpha)) U^T Y.
    Returns [n_alphas, n, d].
    """
    device = resolve_device(device)
    K, Y = as_float32(K, device), as_float32(Y, device)
    lam, U = torch.linalg.eigh(K)
    UtY = U.mT @ Y
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=device)
    return torch.stack([U @ (UtY / (lam + a)[:, None]) for a in alphas])
