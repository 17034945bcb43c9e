"""CV alpha-selection helpers of the ridge layer.

Port of the two helpers of ``multimodal_decoding_tpu/ops/ridge.py`` that the
searchlight's per-vertex CV calls; the whole-brain dual ridge (the rest of
that file) is ROADMAP A8.
"""

from __future__ import annotations

import numpy as np
import torch

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
