"""The study's ridge decoding, written plainly, to judge the program by.

Plain PyTorch in float32 (cuBLAS's TF32 stays off unless a caller turns it
on for the control), one definition per quantity, as the upstream study
states it (mitjanikolaus/multimodal_decoding: ``eval.py`` for the pairwise
accuracy, ``ridge_regression_decoding.py`` for the GridSearchCV over a
5-fold KFold, ``searchlight.py`` for the per-vertex ridge and its null
scores).  It imports nothing of the program and takes nothing the program
made: the patches, grams, folds and splits are worked out here again from
the benchmark's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

# GridSearchCV's argmax, with scores within this band of the best counted as tied
TIE_BAND = 1e-6
# searchlight.py:35, DERANGEMENTS_THREE_DIMS
IMAGERY_DERANGEMENTS = ((1, 2, 0), (2, 0, 1))

CAPTIONS = "pairwise_acc_captions"
IMAGES = "pairwise_acc_images"
CROSS_CAPTIONS_TO_IMAGES = "pairwise_acc_cross_captions_to_images"
CROSS_IMAGES_TO_CAPTIONS = "pairwise_acc_cross_images_to_captions"
IMAGERY = "pairwise_acc_imagery"
IMAGERY_WHOLE_TEST = "pairwise_acc_imagery_whole_test_set"


def kfold_bounds(n: int, n_splits: int) -> list:
    """sklearn ``KFold(shuffle=False)``: contiguous validation ranges, the
    first ``n % n_splits`` one row longer."""
    sizes = [n // n_splits + (1 if i < n % n_splits else 0) for i in range(n_splits)]
    starts = np.cumsum([0] + sizes)
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


def first_best(scores: torch.Tensor, band: float = TIE_BAND) -> torch.Tensor:
    """Index of the first score within ``band`` of the best, along the last axis."""
    best = scores.max(dim=-1, keepdim=True).values
    within = scores >= best - band
    first = torch.arange(scores.shape[-1], device=scores.device).expand_as(scores)
    return torch.where(within, first, scores.shape[-1]).min(dim=-1).values


def standardize(x: torch.Tensor) -> torch.Tensor:
    """sklearn ``StandardScaler`` over the rows (axis -2): ddof 0, a column of
    zero variance keeps its scale."""
    mean = x.mean(dim=-2, keepdim=True)
    std = x.std(dim=-2, keepdim=True, correction=0)
    return (x - mean) / torch.where(std == 0, torch.ones_like(std), std)


def cosine_distances(p: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``1 - <p_i, l_j> / (|p_i| |l_j|)`` over the last two axes."""
    p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    l = l / torch.linalg.vector_norm(l, dim=-1, keepdim=True)
    return 1.0 - p @ l.transpose(-1, -2)


def pairwise_accuracy(dist: torch.Tensor) -> torch.Tensor:
    """eval.py's pairwise accuracy of a distance matrix [.., n, m] (n <= m):
    the share of entries ``dist[i, j]`` above ``dist[i, i]``, over
    ``n * m - min(n, m)``."""
    n, m = dist.shape[-2], dist.shape[-1]
    diag = torch.diagonal(dist, dim1=-2, dim2=-1)[..., :, None]
    return (diag < dist).sum(dim=(-2, -1)).double() / (n * m - min(n, m))


def comparisons(n_test: int, n_imag: int) -> dict:
    """Comparisons each score counts, ``n * m - min(n, m)``, by metric name
    (the ``_no_std`` variants as their standardised twins)."""
    h = n_test // 2
    per_modality = h * h - h
    out = {CAPTIONS: per_modality, IMAGES: per_modality,
           CROSS_CAPTIONS_TO_IMAGES: per_modality, CROSS_IMAGES_TO_CAPTIONS: per_modality,
           IMAGERY: n_imag * n_imag - n_imag,
           IMAGERY_WHOLE_TEST: n_imag * (n_imag + n_test) - n_imag}
    out.update({f"{k}_no_std": v for k, v in list(out.items())})
    return out


def ridge_solve(G: torch.Tensor, B: torch.Tensor, alpha) -> torch.Tensor:
    """``(G + alpha I)^-1 B`` by a Cholesky factorisation; ``alpha`` a number or
    one per leading index."""
    alpha = torch.as_tensor(alpha, dtype=G.dtype, device=G.device)
    A = G + alpha.reshape(alpha.shape + (1, 1)) * torch.eye(G.shape[-1], dtype=G.dtype,
                                                            device=G.device)
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


def score_family(preds_test: torch.Tensor, preds_imag: torch.Tensor, Y_test: torch.Tensor,
                 Y_imag: torch.Tensor, caption_rows, image_rows, no_std: bool) -> dict:
    """The decoder's scores of its test and imagery predictions ([.., n, D]):
    captions, images, the two cross-modal scores and imagery against its own
    latents and against imagery plus test latents, each with predictions
    standardised over its rows; ``no_std`` adds the imagery scores of the raw
    predictions (``<name>_no_std``, as the searchlight reports them)."""
    P_cap, P_img = standardize(preds_test[..., caption_rows, :]), standardize(
        preds_test[..., image_rows, :])
    L_cap, L_img = Y_test[caption_rows], Y_test[image_rows]
    L_whole = torch.cat([Y_imag, Y_test])
    out = {
        CAPTIONS: pairwise_accuracy(cosine_distances(P_cap, L_cap)),
        IMAGES: pairwise_accuracy(cosine_distances(P_img, L_img)),
        CROSS_CAPTIONS_TO_IMAGES: pairwise_accuracy(cosine_distances(P_cap, L_img)),
        CROSS_IMAGES_TO_CAPTIONS: pairwise_accuracy(cosine_distances(P_img, L_cap)),
    }
    variants = [("", standardize(preds_imag))] + ([("_no_std", preds_imag)] if no_std else [])
    for suffix, P in variants:
        out[IMAGERY + suffix] = pairwise_accuracy(cosine_distances(P, Y_imag))
        out[IMAGERY_WHOLE_TEST + suffix] = pairwise_accuracy(cosine_distances(P, L_whole))
    return out
