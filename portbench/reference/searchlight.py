"""The upstream searchlight for a sample of vertices, written plainly.

For each vertex: its neighbours' columns of the betas, a ridge per vertex
(``Ridge(fit_intercept=False)``: ``W = (X^T X + alpha I)^-1 X^T Y``), with
the alpha either fixed or chosen per vertex by a 5-fold KFold CV over the
grid, scored by the pairwise accuracy of each validation fold (the best
alpha is the first within the tie band of the best mean); then the refit on
all train rows, the test and imagery predictions, their scores, and each
null shuffle's scores.  A null shuffle permutes the test latents within
each modality, and the imagery latents by one of the two 3-element
derangements chosen per (vertex, shuffle) (``searchlight.py:38-90``).
"""

from __future__ import annotations

import torch

from portbench.reference import plain as R


def _fold_grams(Xtr: torch.Tensor, Ytr: torch.Tensor, lo: int, hi: int):
    """Gram and cross products of the train rows outside ``[lo, hi)``."""
    Xf = torch.cat([Xtr[:, :lo], Xtr[:, hi:]], dim=1)
    Yf = torch.cat([Ytr[:lo], Ytr[hi:]])
    return Xf.transpose(1, 2) @ Xf, Xf.transpose(1, 2) @ Yf


def select_alpha(Xtr: torch.Tensor, Ytr: torch.Tensor, alphas, n_splits: int) -> tuple:
    """Per-vertex CV: [S, N, K] patches -> (the index of each vertex's alpha,
    the mean CV scores [S, A])."""
    mean = torch.zeros((Xtr.shape[0], len(alphas)), dtype=torch.float64, device=Xtr.device)
    for lo, hi in R.kfold_bounds(Xtr.shape[1], n_splits):
        G, XtY = _fold_grams(Xtr, Ytr, lo, hi)
        Xv, Yv = Xtr[:, lo:hi], Ytr[lo:hi]
        for a, alpha in enumerate(alphas):
            preds = Xv @ R.ridge_solve(G, XtY, alpha)
            mean[:, a] += R.pairwise_accuracy(R.cosine_distances(preds, Yv))
    mean = (mean / n_splits).to(torch.float32)
    return R.first_best(mean), mean


def vertices(X_all: torch.Tensor, neighbours: torch.Tensor, Y_train: torch.Tensor,
             Y_test: torch.Tensor, Y_imag: torch.Tensor, caption_rows, image_rows,
             shuffles: torch.Tensor, derangement_choices: torch.Tensor, alpha=None,
             alphas=None, n_splits: int = 5, chunk: int = 16) -> dict:
    """The searchlight's outputs at ``neighbours`` [S, K] (one row a vertex).

    Returns ``{"alpha": [S] or None, "cv": [S, A] or None, "scores": {metric:
    [S]}, "null": {metric: [S, P]}}`` (numpy; ``cv`` the mean CV scores).
    ``alphas``: the CV grid (``alpha`` is then ignored); ``shuffles`` [P,
    n_test]; ``derangement_choices`` [S, P] in {0, 1}.  Vertices go ``chunk``
    at a time.
    """
    n_train, n_test = len(Y_train), len(Y_test)
    der = torch.as_tensor(R.IMAGERY_DERANGEMENTS, device=X_all.device)
    out_alpha, out_cv, out_scores, out_null = [], [], [], []
    for s in range(0, len(neighbours), chunk):
        idx = neighbours[s:s + chunk].long()
        patches = X_all[:, idx].permute(1, 0, 2)  # [S, N_all, K]
        Xtr = patches[:, :n_train]
        Xte, Xim = patches[:, n_train:n_train + n_test], patches[:, n_train + n_test:]
        if alphas is not None:
            best, cv = select_alpha(Xtr, Y_train, alphas, n_splits)
            a = torch.as_tensor(alphas, dtype=torch.float32, device=X_all.device)[best]
            out_alpha.append(a)
            out_cv.append(cv)
        else:
            a = torch.full((len(idx),), float(alpha), device=X_all.device)
        W = R.ridge_solve(Xtr.transpose(1, 2) @ Xtr, Xtr.transpose(1, 2) @ Y_train, a)
        P_te, P_im = Xte @ W, Xim @ W
        out_scores.append(R.score_family(P_te, P_im, Y_test, Y_imag, caption_rows, image_rows,
                                         no_std=True))
        out_null.append(_null(P_te, P_im, Y_test, Y_imag, caption_rows, image_rows, shuffles,
                              der[derangement_choices[s:s + chunk].long()]))
        del patches, Xtr, Xte, Xim
    return {"alpha": torch.cat(out_alpha).cpu().numpy() if out_alpha else None,
            "cv": torch.cat(out_cv).cpu().numpy() if out_cv else None,
            "scores": {m: torch.cat([c[m] for c in out_scores]).cpu().numpy()
                       for m in out_scores[0]},
            "null": {m: torch.cat([c[m] for c in out_null]).cpu().numpy() for m in out_null[0]}}


def _null(P_te, P_im, Y_test, Y_imag, caption_rows, image_rows, shuffles, der) -> dict:
    """Each shuffle's scores [S, P]: the accuracy with the latents permuted,
    i.e. with the columns of the distance matrix permuted."""
    out = {}
    for name, rows in ((R.CAPTIONS, caption_rows), (R.IMAGES, image_rows)):
        dist = R.cosine_distances(R.standardize(P_te[:, rows]), Y_test[rows])  # [S, n, n]
        local = torch.argsort(rows)[torch.searchsorted(rows.sort().values,
                                                       shuffles[:, rows])]  # [P, n]
        out[name] = torch.stack([R.pairwise_accuracy(dist[:, :, perm]) for perm in local],
                                dim=1)
    L_whole = torch.cat([Y_imag, Y_test])
    n_imag = len(Y_imag)
    for suffix, P in (("", R.standardize(P_im)), ("_no_std", P_im)):
        for name, L in ((R.IMAGERY, Y_imag), (R.IMAGERY_WHOLE_TEST, L_whole)):
            dist = R.cosine_distances(P, L)  # [S, 3, m]
            cols = torch.arange(L.shape[0], device=P.device).expand(der.shape[:2] + (-1,))
            cols = torch.cat([der, cols[..., n_imag:]], dim=-1)  # [S, P, m]
            permuted = torch.gather(dist[:, None].expand(-1, der.shape[1], -1, -1), 3,
                                    cols[:, :, None, :].expand(-1, -1, n_imag, -1))
            out[name + suffix] = R.pairwise_accuracy(permuted)
    return out
