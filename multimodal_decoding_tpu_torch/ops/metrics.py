"""Pairwise cosine-ranking accuracy on batched tensors.

Port of ``multimodal_decoding_tpu/ops/metrics.py`` up to its score family:
sklearn-style ``standardize``/``fit_standardizer``, cosine and euclidean
distances, the pairwise-accuracy forms (batched over leading axes) and the
per-modality, cross-modal and imagery score family of the whole-brain
decoder, the host RSA helpers (copies) and the CSLS distance on the device.
The metric-name constants are the reference's public API (its
eval.py:9-79) and are kept verbatim, so result pickles keyed by them are
interchangeable with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.config import (
    CAPTION,
    IMAGE,
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
)
from multimodal_decoding_tpu_torch.device import as_float32
from multimodal_decoding_tpu_torch.ops.precision import matmul as _matmul

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
    mean, scale = fit_standardizer(x, axis)
    return (x - mean) / scale


def fit_standardizer(x: torch.Tensor, axis: int = -2):
    """Return (mean, scale) with sklearn semantics; apply via (v - mean)/scale."""
    mean = torch.mean(x, dim=axis, keepdim=True)
    std = torch.std(x, dim=axis, keepdim=True, correction=0)
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return mean, scale


def cosine_distances(preds: torch.Tensor, latents: torch.Tensor,
                     precision="highest") -> torch.Tensor:
    """Cosine distance matrix ``1 - <p, l> / (|p||l|)`` (cdist 'cosine').

    ``precision`` (``ops/precision.py``) is the product's; the CV selection
    path passes a cheaper one.
    """
    p = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True)
    l = latents / torch.linalg.vector_norm(latents, dim=-1, keepdim=True)
    return 1.0 - _matmul(p, l.mT, precision)


def euclidean_distances(preds: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix via |p|^2 - 2<p,l> + |l|^2 (one matrix product)."""
    p_sq = torch.sum(preds * preds, dim=-1)[..., :, None]
    l_sq = torch.sum(latents * latents, dim=-1)[..., None, :]
    return torch.sqrt(torch.clamp(p_sq - 2.0 * (preds @ latents.mT) + l_sq, min=0.0))


def get_distance_matrix(predictions, originals, metric: str = "cosine", device=None):
    """Metric dispatch (parity surface of eval.py:103-104)."""
    p, o = as_float32(predictions, device), as_float32(originals, device)
    if metric == "cosine":
        return cosine_distances(p, o)
    if metric == "euclidean":
        return euclidean_distances(p, o)
    raise ValueError(f"unsupported distance metric: {metric}")


def pairwise_acc_from_dist(dist: torch.Tensor) -> torch.Tensor:
    """Fraction of off-diagonal entries beaten by the diagonal.

    ``diag < dist`` counted over the whole [n, m] matrix (n <= m), normalised
    by ``n*m - min(n, m)`` (reference eval.py:107-113).
    """
    n, m = dist.shape[-2], dist.shape[-1]
    diag = torch.diagonal(dist, dim1=-2, dim2=-1)[..., :, None]
    corrects = torch.sum(diag < dist, dim=(-2, -1))
    return count_ratio(corrects, n * m - min(n, m))


def pairwise_acc_scale_invariant(predictions: torch.Tensor, latents_normalized: torch.Tensor,
                                 precision="highest") -> torch.Tensor:
    """Cosine pairwise accuracy without normalising the predictions.

    ``dist_ii < dist_ij <=> sim_ij < sim_ii`` for ``sim = P Y^T`` with unit
    latent rows: every entry of row i shares the factor ``1/|p_i|``.
    ``sim`` is float32, its product at ``precision``.
    """
    return pairwise_acc_from_sim(_matmul(predictions, latents_normalized.mT, precision))


def pairwise_acc_from_sim(sim: torch.Tensor) -> torch.Tensor:
    """Pairwise accuracy from a (row-scale-free) similarity matrix."""
    n, m = sim.shape[-2], sim.shape[-1]
    diag = torch.diagonal(sim, dim1=-2, dim2=-1)[..., :, None]
    counts = torch.sum(sim < diag, dim=(-2, -1))
    return count_ratio(counts, n * m - min(n, m))


def pairwise_accuracy(
    latents,
    predictions,
    standardize_predictions: bool = False,
    standardize_latents: bool = False,
    metric: str = "cosine",
    device=None,
) -> torch.Tensor:
    """Pairwise 2-AFC accuracy (reference: eval.py:116-123).

    Tensors stay on their device; arrays go to ``device`` (``None``: cuda).
    """
    latents, predictions = as_float32(latents, device), as_float32(predictions, device)
    if standardize_predictions:
        predictions = standardize(predictions)
    if standardize_latents:
        latents = standardize(latents)
    return pairwise_acc_from_dist(get_distance_matrix(predictions, latents, metric))


# ---------------------------------------------------------------------------
# Score family (reference: eval.py:126-181)
# ---------------------------------------------------------------------------


def calc_imagery_pairwise_accuracy_scores(
    imagery_latents,
    imagery_predictions,
    additional_latents,
    standardize_predictions: bool = False,
    standardize_latents: bool = False,
    test_set_preds=None,
    device=None,
) -> dict:
    """Imagery scored against its own latents and against imagery+test latents.

    Mirrors eval.py:161-181 including the optional normalisation of imagery
    predictions with statistics from (imagery + test) predictions.
    """
    imagery_latents = as_float32(imagery_latents, device)
    imagery_predictions = as_float32(imagery_predictions, device)
    additional_latents = as_float32(additional_latents, device)
    results = {}

    if test_set_preds is not None:
        all_preds = torch.cat((imagery_predictions, as_float32(test_set_preds, device)), dim=-2)
        mean, scale = fit_standardizer(all_preds)
        imagery_predictions = (imagery_predictions - mean) / scale
        standardize_predictions = False

    results[ACC_IMAGERY] = pairwise_accuracy(
        imagery_latents, imagery_predictions, standardize_predictions, standardize_latents
    )

    target_latents = torch.cat((imagery_latents, additional_latents), dim=-2)
    results[ACC_IMAGERY_WHOLE_TEST] = pairwise_accuracy(
        target_latents, imagery_predictions, standardize_predictions, standardize_latents
    )
    return results


def calc_all_pairwise_accuracy_scores(
    latents,
    predictions,
    stim_types=None,
    imagery_latents=None,
    imagery_predictions=None,
    standardize_predictions: bool = True,
    standardize_latents: bool = False,
    norm_imagery_preds_with_test_preds: bool = False,
    comp_cross_decoding_scores: bool = True,
    device=None,
) -> dict:
    """Per-modality + cross-modal + imagery score family (eval.py:126-158).

    ``stim_types`` is a host-side numpy array of strings ('caption'/'image');
    its masks index the tensors from the host, as in the JAX package.  The
    scores are 0-d float32 tensors on the inputs' device.
    """
    latents, predictions = as_float32(latents, device), as_float32(predictions, device)
    stim_types = np.asarray(stim_types)
    results = {}
    for modality, acc_metric_name in zip([CAPTION, IMAGE], [ACC_CAPTIONS, ACC_IMAGES]):
        sel = torch.as_tensor(stim_types == modality, device=latents.device)
        results[acc_metric_name] = pairwise_accuracy(
            latents[..., sel, :],
            predictions[..., sel, :],
            standardize_predictions,
            standardize_latents,
        )

    if comp_cross_decoding_scores:
        for mod_preds, mod_latents, acc_metric_name in zip(
            [CAPTION, IMAGE],
            [IMAGE, CAPTION],
            [ACC_CROSS_CAPTIONS_TO_IMAGES, ACC_CROSS_IMAGES_TO_CAPTIONS],
        ):
            lat_sel = torch.as_tensor(stim_types == mod_latents, device=latents.device)
            pred_sel = torch.as_tensor(stim_types == mod_preds, device=latents.device)
            results[acc_metric_name] = pairwise_accuracy(
                latents[..., lat_sel, :],
                predictions[..., pred_sel, :],
                standardize_predictions,
                standardize_latents,
            )

    if imagery_latents is not None:
        results.update(
            calc_imagery_pairwise_accuracy_scores(
                as_float32(imagery_latents, latents.device),
                as_float32(imagery_predictions, latents.device),
                latents,
                standardize_predictions,
                standardize_latents,
                test_set_preds=predictions if norm_imagery_preds_with_test_preds else None,
            )
        )
    return results


# ---------------------------------------------------------------------------
# RSA (reference: eval.py:184-223).  Host-side helper; small inputs, not hot.
# ---------------------------------------------------------------------------


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks per row (scipy.stats.rankdata equivalent, axis=-1)."""
    from scipy.stats import rankdata

    return rankdata(x, axis=-1)


def create_dissimilarity_matrix(sample_embeds: np.ndarray, matrix_metric: str = "spearmanr"):
    """Upper triangle of 1 - row-correlation matrix (eval.py:184-193)."""
    sample_embeds = np.asarray(sample_embeds)
    if matrix_metric == "spearmanr":
        ranks = _rankdata(sample_embeds)
        sim_mat = np.corrcoef(ranks, rowvar=True)
    elif matrix_metric == "pearsonr":
        sim_mat = np.corrcoef(sample_embeds, rowvar=True)
    else:
        raise RuntimeError("Unknown metric: " + matrix_metric)
    dissim = 1.0 - sim_mat
    iu = np.triu_indices(sample_embeds.shape[0], 1)
    return dissim[iu].reshape(-1)


def rsa_from_matrices(matrix_1, matrix_2, metric: str = "spearmanr") -> float:
    if metric == "spearmanr":
        r1 = _rankdata(np.asarray(matrix_1)[None, :])[0]
        r2 = _rankdata(np.asarray(matrix_2)[None, :])[0]
        return float(np.corrcoef(r1, r2)[0, 1])
    elif metric == "pearsonr":
        return float(np.corrcoef(matrix_1, matrix_2)[0, 1])
    raise RuntimeError("Unknown metric: " + metric)


def calc_rsa(latent_1, latent_2, metric="spearmanr", matrix_metric="spearmanr") -> float:
    m1 = create_dissimilarity_matrix(latent_1, matrix_metric)
    m2 = create_dissimilarity_matrix(latent_2, matrix_metric)
    return rsa_from_matrices(m1, m2, metric=metric)


def calc_rsa_images(latent_1, latent_2, stimulus_types, metric="spearmanr", matrix_metric="spearmanr"):
    stimulus_types = np.asarray(stimulus_types)
    assert len(latent_1) == len(latent_2) == len(stimulus_types)
    return calc_rsa(
        latent_1[stimulus_types == IMAGE], latent_2[stimulus_types == IMAGE], metric, matrix_metric
    )


def calc_rsa_captions(latent_1, latent_2, stimulus_types, metric="spearmanr", matrix_metric="spearmanr"):
    stimulus_types = np.asarray(stimulus_types)
    assert len(latent_1) == len(latent_2) == len(stimulus_types)
    return calc_rsa(
        latent_1[stimulus_types == CAPTION], latent_2[stimulus_types == CAPTION], metric, matrix_metric
    )


def get_distance_matrix_csls(predictions, latents, knn: int = 100, device=None):
    """CSLS-adjusted cosine distance matrix (batched over leading axes).

    The standard CSLS formulation, as the JAX package's (not the reference's
    eval.py:82-100, whose ``distances[best_distances_idx]`` gathers whole
    rows): ``2*d(p,l) - r(p) - r(l)`` with r = mean distance to the ``knn``
    nearest neighbours in the other set (all of them when ``knn`` is larger).
    Tensors stay on their device; arrays go to ``device`` (``None``: cuda).
    """
    d = cosine_distances(as_float32(predictions, device), as_float32(latents, device))

    def knn_mean(dist, k):
        # mean of the k smallest distances along the last axis
        return torch.topk(dist, k, dim=-1, largest=False).values.mean(dim=-1)

    r_preds = knn_mean(d, min(knn, d.shape[-1]))  # [..., n_preds]
    r_lats = knn_mean(d.mT, min(knn, d.shape[-2]))  # [..., n_lat]
    return 2.0 * d - r_preds[..., :, None] - r_lats[..., None, :]
