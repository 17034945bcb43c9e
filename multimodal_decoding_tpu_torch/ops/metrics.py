"""Pairwise cosine-ranking accuracy on batched tensors.

Port of the subset of ``multimodal_decoding_tpu/ops/metrics.py`` that the
searchlight slice calls: sklearn-style ``standardize``, ``cosine_distances``
and the three pairwise-accuracy forms, all batched over leading axes.  The
metric-name constants are the reference's public API (its eval.py:9-79) and
are kept verbatim, so result pickles keyed by them are interchangeable with
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.config import (
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
)

# ---------------------------------------------------------------------------
# Metric name constants (reference: eval.py:9-79)
# ---------------------------------------------------------------------------

ACC_MODALITY_AGNOSTIC = "pairwise_acc_modality_agnostic"
ACC_CAPTIONS = "pairwise_acc_captions"
ACC_IMAGES = "pairwise_acc_images"

ACC_CROSS_IMAGES_TO_CAPTIONS = "pairwise_acc_cross_images_to_captions"
ACC_CROSS_CAPTIONS_TO_IMAGES = "pairwise_acc_cross_captions_to_images"

ACC_IMAGES_MOD_AGNOSTIC = "pairwise_acc_images_mod_agnostic"
ACC_CAPTIONS_MOD_AGNOSTIC = "pairwise_acc_captions_mod_agnostic"
ACC_IMAGERY_MOD_AGNOSTIC = "pairwise_acc_imagery_mod_agnostic"
ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC = "pairwise_acc_imagery_whole_test_set_mod_agnostic"

ACC_IMAGERY_NO_STD_MOD_AGNOSTIC = "pairwise_acc_imagery_no_std_mod_agnostic"
ACC_IMAGERY_WHOLE_TEST_SET_NO_STD_MOD_AGNOSTIC = (
    "pairwise_acc_imagery_whole_test_set_no_std_mod_agnostic"
)

ACC_IMAGES_MOD_SPECIFIC_IMAGES = "pairwise_acc_images_mod_specific_images"
ACC_CAPTIONS_MOD_SPECIFIC_IMAGES = "pairwise_acc_captions_mod_specific_images"

ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS = "pairwise_acc_captions_mod_specific_captions"
ACC_IMAGES_MOD_SPECIFIC_CAPTIONS = "pairwise_acc_images_mod_specific_captions"

ACC_IMAGERY_MOD_SPECIFIC_CAPTIONS = "pairwise_acc_imagery_mod_specific_captions"
ACC_IMAGERY_MOD_SPECIFIC_IMAGES = "pairwise_acc_imagery_mod_specific_images"

ACC_IMAGERY_WHOLE_TEST_SET_MOD_SPECIFIC_CAPTIONS = (
    "pairwise_acc_imagery_whole_test_mod_specific_captions"
)
ACC_IMAGERY_WHOLE_TEST_SET_MOD_SPECIFIC_IMAGES = (
    "pairwise_acc_imagery_whole_test_mod_specific_images"
)

ACC_IMAGERY_NO_STD_MOD_SPECIFIC_CAPTIONS = "pairwise_acc_imagery_no_std_mod_specific_captions"
ACC_IMAGERY_NO_STD_MOD_SPECIFIC_IMAGES = "pairwise_acc_imagery_no_std_mod_specific_images"

ACC_IMAGERY_WHOLE_TEST_SET_NO_STD_MOD_SPECIFIC_CAPTIONS = (
    "pairwise_acc_imagery_whole_test_no_std_mod_specific_captions"
)
ACC_IMAGERY_WHOLE_TEST_SET_NO_STD_MOD_SPECIFIC_IMAGES = (
    "pairwise_acc_imagery_whole_test_no_std_mod_specific_images"
)

ACC_IMAGERY = "pairwise_acc_imagery"
ACC_IMAGERY_WHOLE_TEST = "pairwise_acc_imagery_whole_test_set"

CORR_ALL = "corr"
CORR_CAPTIONS = "corr_captions"
CORR_IMAGES = "corr_images"

CORR_CAPTIONS_MOD_AGNOSTIC = "corr_captions_mod_agnostic"
CORR_IMAGES_MOD_AGNOSTIC = "corr_images_mod_agnostic"
CORR_CAPTIONS_MOD_SPECIFIC_CAPTIONS = "corr_captions_mod_specific_captions"
CORR_IMAGES_MOD_SPECIFIC_CAPTIONS = "corr_images_mod_specific_captions"
CORR_IMAGES_MOD_SPECIFIC_IMAGES = "corr_images_mod_specific_images"
CORR_CAPTIONS_MOD_SPECIFIC_IMAGES = "corr_captions_mod_specific_images"

METRIC_CROSS_ENCODING = "cross_encoding"

DISTANCE_METRIC_COSINE = "cosine"

CHANCE_VALUES = {
    ACC_CAPTIONS_MOD_AGNOSTIC: 0.5,
    ACC_IMAGES_MOD_AGNOSTIC: 0.5,
    ACC_IMAGERY_MOD_AGNOSTIC: 0.5,
    ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC: 0.5,
    ACC_IMAGES_MOD_SPECIFIC_IMAGES: 0.5,
    ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS: 0.5,
    ACC_CAPTIONS_MOD_SPECIFIC_IMAGES: 0.5,
    ACC_IMAGES_MOD_SPECIFIC_CAPTIONS: 0.5,
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC: 0,
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC: 0,
    CORR_CAPTIONS_MOD_AGNOSTIC: 0,
    CORR_IMAGES_MOD_AGNOSTIC: 0,
    CORR_CAPTIONS_MOD_SPECIFIC_CAPTIONS: 0,
    CORR_IMAGES_MOD_SPECIFIC_CAPTIONS: 0,
    CORR_IMAGES_MOD_SPECIFIC_IMAGES: 0,
    CORR_CAPTIONS_MOD_SPECIFIC_IMAGES: 0,
}


# ---------------------------------------------------------------------------
# Primitives (batched over arbitrary leading axes)
# ---------------------------------------------------------------------------


def count_ratio(counts: torch.Tensor, denom: int) -> torch.Tensor:
    """``counts / denom`` in float32, rounded as the JAX package's jitted steps round it.

    XLA rewrites a division by a constant into a product with the float32
    reciprocal, so ``9 / 20`` comes out as ``0.45000002``, not ``0.45``.
    Multiplying by the same reciprocal keeps accuracies bit-equal to the JAX
    package's block steps.
    """
    return counts.to(torch.float32) * float(np.float32(1.0) / np.float32(denom))


def standardize(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Column-wise standardisation with sklearn StandardScaler semantics.

    ddof=0 std; zero-variance columns are left unscaled (scale -> 1).
    """
    mean = torch.mean(x, dim=axis, keepdim=True)
    std = torch.std(x, dim=axis, keepdim=True, correction=0)
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return (x - mean) / scale


def cosine_distances(preds: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Cosine distance matrix ``1 - <p, l> / (|p||l|)`` (cdist 'cosine')."""
    p = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True)
    l = latents / torch.linalg.vector_norm(latents, dim=-1, keepdim=True)
    return 1.0 - p @ l.mT


def pairwise_acc_from_dist(dist: torch.Tensor) -> torch.Tensor:
    """Fraction of off-diagonal entries beaten by the diagonal.

    ``diag < dist`` counted over the whole [n, m] matrix (n <= m), normalised
    by ``n*m - min(n, m)`` (reference eval.py:107-113).
    """
    n, m = dist.shape[-2], dist.shape[-1]
    diag = torch.diagonal(dist, dim1=-2, dim2=-1)[..., :, None]
    corrects = torch.sum(diag < dist, dim=(-2, -1))
    return count_ratio(corrects, n * m - min(n, m))


def pairwise_acc_scale_invariant(predictions: torch.Tensor,
                                 latents_normalized: torch.Tensor) -> torch.Tensor:
    """Cosine pairwise accuracy without normalising the predictions.

    ``dist_ii < dist_ij <=> sim_ij < sim_ii`` for ``sim = P Y^T`` with unit
    latent rows: every entry of row i shares the factor ``1/|p_i|``.
    """
    return pairwise_acc_from_sim(predictions @ latents_normalized.mT)


def pairwise_acc_from_sim(sim: torch.Tensor) -> torch.Tensor:
    """Pairwise accuracy from a (row-scale-free) similarity matrix."""
    n, m = sim.shape[-2], sim.shape[-1]
    diag = torch.diagonal(sim, dim1=-2, dim2=-1)[..., :, None]
    counts = torch.sum(sim < diag, dim=(-2, -1))
    return count_ratio(counts, n * m - min(n, m))
