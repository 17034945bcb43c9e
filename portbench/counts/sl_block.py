"""Least work of one searchlight block: the method's, whatever implements it.

Per vertex the method fits a ridge on its K neighbours' columns of the N
train rows (``W = (G + alpha I)^-1 X^T Y``, G = X^T X), predicts the test
and imagery rows and scores them by cosine pairwise accuracy; with an alpha
grid it first scores each alpha on each of the F validation folds.  Each
term is a lower bound that any faithful implementation pays:

* ``gram``: G once per distinct entry, K (K + 1) / 2 sums of N products.
  The folds' validation grams partition the rows and sum to G, so the fold
  grams (G minus a validation gram) cost no more;
* ``cross``: X^T Y, K x D sums of N products (the folds' likewise);
* ``fold_factor``: a factorisation of each (fold, alpha) system, K^3 / 3;
* ``fold_similarity``: each (fold, alpha)'s similarity of the nv validation
  predictions to the nv validation latents, nv^2 entries of rank K
  (K < D): 2 K nv^2;
* ``refit_factor``: K^3 / 3 for the chosen alpha;
* ``predict``: the nq = test + imagery predictions through the refit
  system, 2 nq K (K + D);
* ``score_distances``: the distances the scores compare, 2 D a pair (the
  null scores permute the same distances and add no products);
* ``gather``: each distinct betas column the block's neighbourhoods touch,
  read once (all N_all rows); ``latents``: the latents, read once.

Operations are float32 (the configuration's precision), counted at 2 a
multiply-add; comparisons are not counted.
"""

from __future__ import annotations


def fold_sizes(n: int, n_splits: int) -> list:
    """sklearn KFold's validation fold sizes."""
    return [n // n_splits + (1 if i < n % n_splits else 0) for i in range(n_splits)]


def score_pairs(n_test: int, n_imag: int) -> int:
    """Prediction-latent pairs the searchlight's scores compare: captions,
    images and both cross-modal scores over the test halves; imagery against
    its own and against imagery plus test latents, standardised and not."""
    half = n_test // 2
    return 4 * half * half + 2 * (n_imag * n_imag + n_imag * (n_imag + n_test))


def terms(n_train: int, n_test: int, n_imag: int, k: int, d: int, n_splits: int,
          n_alphas: int, n_vertices: int, unique_cols: int) -> dict:
    """{name: (flops, bytes)} of a block of ``n_vertices`` vertices whose
    neighbourhoods touch ``unique_cols`` distinct columns; ``n_alphas`` 0 for a
    fixed alpha."""
    n_all = n_train + n_test + n_imag
    nq = n_test + n_imag
    v = n_vertices
    t = {
        "gram": (v * n_train * k * (k + 1), 0),
        "cross": (v * 2 * n_train * k * d, 0),
        "refit_factor": (v * k ** 3 / 3, 0),
        "predict": (v * 2 * nq * k * (k + d), 0),
        "score_distances": (v * 2 * d * score_pairs(n_test, n_imag), 0),
        "gather": (0, unique_cols * n_all * 4),
        "latents": (0, n_all * d * 4),
    }
    if n_alphas:
        t["fold_factor"] = (v * n_splits * n_alphas * k ** 3 / 3, 0)
        t["fold_similarity"] = (v * n_alphas * 2 * k * sum(nv * nv for nv in
                                                           fold_sizes(n_train, n_splits)), 0)
    return t
