"""The upstream whole-brain decoder, written plainly.

``ridge_regression_decoding.py``: ``GridSearchCV(Ridge(fit_intercept=False),
scoring=pairwise_accuracy, cv=KFold(5))`` over the alpha grid, the refit on
all train rows, the test and imagery predictions and their scores.  With
many more features than stimuli the ridge is solved in its dual form,
``pred(Xq) = Xq X^T (X X^T + alpha I)^-1 Y``, which is the same function of
the data; so the kernels ``X X^T`` and ``Xq X^T`` are formed here from the
host betas, column block by column block.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import plain as R


def kernels(X_train: np.ndarray, queries: list, device, block_cols: int = 16384) -> tuple:
    """``X X^T`` [n, n] and ``Xq X^T`` [nq, n] for each query, in float32."""
    n = X_train.shape[0]
    K = torch.zeros((n, n), dtype=torch.float32, device=device)
    Kq = [torch.zeros((q.shape[0], n), dtype=torch.float32, device=device) for q in queries]
    for lo in range(0, X_train.shape[1], block_cols):
        x = torch.from_numpy(np.ascontiguousarray(X_train[:, lo:lo + block_cols])).to(device)
        K += x @ x.T
        for k, q in zip(Kq, queries):
            k += torch.from_numpy(np.ascontiguousarray(q[:, lo:lo + block_cols])).to(device) @ x.T
    return K, Kq


def decode(K: torch.Tensor, K_test: torch.Tensor, K_imag: torch.Tensor, Y_train: torch.Tensor,
           Y_test: torch.Tensor, Y_imag: torch.Tensor, alphas, caption_rows, image_rows,
           n_splits: int = 5) -> dict:
    """One decode: the CV mean-score grid, the chosen alpha, the test and
    imagery predictions and their scores (numpy)."""
    n = K.shape[0]
    mean = torch.zeros(len(alphas), dtype=torch.float64, device=K.device)
    for lo, hi in R.kfold_bounds(n, n_splits):
        tr = torch.cat([torch.arange(0, lo), torch.arange(hi, n)]).to(K.device)
        K_tt, K_vt = K[tr][:, tr], K[lo:hi][:, tr]
        for a, alpha in enumerate(alphas):
            preds = K_vt @ R.ridge_solve(K_tt, Y_train[tr], alpha)
            mean[a] += R.pairwise_accuracy(R.cosine_distances(preds, Y_train[lo:hi]))
    mean = (mean / n_splits).to(torch.float32)
    best = int(R.first_best(mean))
    dual = R.ridge_solve(K, Y_train, alphas[best])
    P_te, P_im = K_test @ dual, K_imag @ dual
    scores = R.score_family(P_te, P_im, Y_test, Y_imag, caption_rows, image_rows, no_std=False)
    return {"alpha": float(alphas[best]), "cv_scores": mean.cpu().numpy(),
            "test_preds": P_te.cpu().numpy(), "imagery_preds": P_im.cpu().numpy(),
            "scores": {k: float(v) for k, v in scores.items()}}
