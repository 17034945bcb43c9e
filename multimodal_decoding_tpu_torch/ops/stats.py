"""Group-level statistics: batched t-maps, composite metrics, p-values.

Port of ``multimodal_decoding_tpu/ops/stats.py``.  A ``[S, V]``
subject-by-vertex score tensor maps to a ``[V]`` t-map in one pass on the
device, and the group null is one gather per chunk of permutations:
``scores[arange(S), perms]`` -> ``[C, S, V]`` -> ``[C, V]`` t-maps, with the
composite metric's member-wise minimum kept on the device
(``null_min_t_maps``).  With a ``"v"`` mesh the sweep splits each chunk of
permutations over the ranks and all-gathers the min-maps
(``null_min_t_sweep``).  The numpy helpers (``group_permutations``,
``p_values_from_null_max``, ``significance_cutoff``) are copies.

Arithmetic follows the JAX functions: the variance is two-pass (mean, then
the centred squares, ``ddof=1``) as ``jnp.var`` computes it, the
degenerate-vertex guard compares the raw scores (before ``popmean`` is
subtracted), and NaN scores propagate to NaN t-values.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from multimodal_decoding_tpu_torch.config import (
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_CROSS_DECODING,
    METRIC_DIFF_MOD_AGNOSTIC_MOD_SPECIFIC,
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
)
from multimodal_decoding_tpu_torch.device import as_float32
from multimodal_decoding_tpu_torch.parallel.mesh import pad_to_multiple
from multimodal_decoding_tpu_torch.parallel.multihost import all_gather_rows, host_shard_bounds
from multimodal_decoding_tpu_torch.ops.metrics import (
    ACC_CAPTIONS_MOD_AGNOSTIC,
    ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS,
    ACC_CAPTIONS_MOD_SPECIFIC_IMAGES,
    ACC_IMAGERY_MOD_AGNOSTIC,
    ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC,
    ACC_IMAGES_MOD_AGNOSTIC,
    ACC_IMAGES_MOD_SPECIFIC_CAPTIONS,
    ACC_IMAGES_MOD_SPECIFIC_IMAGES,
)

# Metrics that get observed + null t-maps (reference: permutation_testing.py:40-46)
T_VAL_METRICS = [
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
    ACC_IMAGES_MOD_SPECIFIC_IMAGES,
    ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS,
    ACC_IMAGES_MOD_AGNOSTIC,
    ACC_CAPTIONS_MOD_AGNOSTIC,
    ACC_IMAGERY_MOD_AGNOSTIC,
    ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC,
    ACC_CAPTIONS_MOD_SPECIFIC_IMAGES,
    ACC_IMAGES_MOD_SPECIFIC_CAPTIONS,
]

# Composite metrics = nanmin over these constituents (permutation_testing.py:271-291)
COMPOSITE_METRICS = {
    METRIC_MOD_AGNOSTIC_AND_CROSS: [
        ACC_IMAGES_MOD_AGNOSTIC,
        ACC_CAPTIONS_MOD_AGNOSTIC,
        ACC_CAPTIONS_MOD_SPECIFIC_IMAGES,
        ACC_IMAGES_MOD_SPECIFIC_CAPTIONS,
    ],
    METRIC_DIFF_MOD_AGNOSTIC_MOD_SPECIFIC: [
        METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
        METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
        ACC_IMAGES_MOD_AGNOSTIC,
        ACC_CAPTIONS_MOD_AGNOSTIC,
    ],
    METRIC_CROSS_DECODING: [
        ACC_IMAGES_MOD_SPECIFIC_CAPTIONS,
        ACC_CAPTIONS_MOD_SPECIFIC_IMAGES,
    ],
}


def _tensor(x, device=None) -> torch.Tensor:
    """A tensor stays as it is (moved to ``device`` if one is named); anything
    else becomes float32 on ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return as_float32(x, device)


def ttest_1samp_no_p(x, sigma: float = 0.0, method: str = "relative", dim: int = 0,
                     device=None) -> torch.Tensor:
    """One-sample t (no p), MNE 'hat'-adjustable variance.

    Parity with permutation_testing.py:213-242: ``mean / sqrt(var_ddof1 / n)``
    reduced over ``dim``; the other axes are batched (vertices).
    """
    x = _tensor(x, device)
    n = x.shape[dim]
    mean = x.mean(dim)
    var = ((x - mean.unsqueeze(dim)) ** 2).sum(dim) / (n - 1)
    if sigma > 0:
        limit = sigma * var.max() if method == "relative" else sigma
        var = var + limit
    return mean / torch.sqrt(var / n)


def t_map(scores, popmean: float, sigma: float = 0.0, dim: int = 0,
          device=None) -> torch.Tensor:
    """[S, V] per-subject score maps -> [V] t-map (subjects along ``dim``).

    Vertices where all subjects have the identical value get NaN (reference
    ``calc_t_value`` guard, permutation_testing.py:245-251); NaN scores
    propagate to NaN t-values as in numpy.
    """
    scores = _tensor(scores, device)
    t = ttest_1samp_no_p(scores - popmean, sigma=sigma, dim=dim)
    degenerate = torch.all(scores == scores.narrow(dim, 0, 1), dim=dim)
    return torch.where(degenerate, torch.full_like(t, float("nan")), t)


def _nanmin0(stacked: torch.Tensor) -> torch.Tensor:
    """Minimum over axis 0 ignoring NaN; NaN where every member is NaN."""
    isnan = torch.isnan(stacked)
    mn = torch.where(isnan, torch.full_like(stacked, float("inf")), stacked).amin(0)
    return torch.where(isnan.all(0), torch.full_like(mn, float("nan")), mn)


def composite_t_maps(t_values: dict, device=None) -> dict:
    """Add nanmin-composite metrics to a {metric: [V]} dict (in a copy)."""
    out = dict(t_values)
    for name, members in COMPOSITE_METRICS.items():
        out[name] = _nanmin0(torch.stack([_tensor(out[m], device) for m in members]))
    return out


def _gather(scores: torch.Tensor, permutations) -> torch.Tensor:
    """[S, P_subj, V] scores, [C, S] permutations -> [C, S, V]: subject s
    takes its perm[s]-th within-subject permutation."""
    perms = torch.as_tensor(np.asarray(permutations), dtype=torch.int64, device=scores.device)
    subjects = torch.arange(scores.shape[0], device=scores.device)
    return scores[subjects[None, :], perms]


def null_t_maps(scores, permutations, popmean: float, device=None) -> torch.Tensor:
    """Null-distribution t-maps as one batched tensor op.

    ``scores``: [S, P_subj, V] per-subject per-within-subject-permutation score
    maps; ``permutations``: [P_group, S] integer matrix choosing one
    within-subject permutation per subject.  Returns [P_group, V] t-maps.
    """
    return t_map(_gather(_tensor(scores, device), permutations), popmean, dim=1)


def null_min_t_maps(stacks, permutations, popmeans) -> torch.Tensor:
    """Member-wise minimum of the null t-maps of a composite metric.

    ``stacks``: one [S, P_subj, V] tensor per member metric, ``popmeans``
    their chance levels; returns [P_group, V].  A member's NaN t-value never
    wins; a vertex where every member is NaN (or the minimum is infinite) is
    NaN, as in the JAX package's host loop (decoding/permutation.py:429-456).
    """
    t_min = any_valid = None
    for scores, popmean in zip(stacks, popmeans):
        t = null_t_maps(scores, permutations, popmean)
        valid = ~torch.isnan(t)
        if t_min is None:
            t_min = torch.where(valid, t, torch.full_like(t, float("inf")))
            any_valid = valid
        else:
            t_min = torch.where(valid & (t < t_min), t, t_min)
            any_valid |= valid
        del t, valid
    nan = torch.full_like(t_min, float("nan"))
    t_min = torch.where(any_valid, t_min, nan)
    return torch.where(torch.isinf(t_min), nan, t_min)


def null_min_t_sweep(stacks, permutations, popmeans, chunk: int, mesh=None):
    """The group-null sweep: yields ``(start, [c, V] t_min)`` per chunk of
    ``chunk`` permutations, each computed on the stacks' device.

    With a ``mesh`` (every rank holds the same stacks), each chunk is padded
    to a multiple of the world size by repeating its first permutation, each
    rank sweeps its slice, and one all_gather gives every rank the chunk's
    min-maps (a collective per chunk).
    """
    permutations = np.asarray(permutations)
    for start in range(0, len(permutations), chunk):
        block = permutations[start:start + chunk]
        if mesh is None:
            yield start, null_min_t_maps(stacks, block, popmeans)
            continue
        padded, n_block = pad_to_multiple(block, mesh.size)
        lo, hi = host_shard_bounds(len(padded), mesh.rank, mesh.size)
        yield start, all_gather_rows(null_min_t_maps(stacks, padded[lo:hi], popmeans),
                                     mesh)[:n_block]


def group_permutations(n_within: int, n_subjects: int, n_group: int) -> np.ndarray:
    """First ``n_group`` tuples of itertools.permutations(range(n_within), n_subjects).

    Exactly the reference's sampling scheme (permutation_testing.py:504-506):
    deterministic lexicographic enumeration, not random sampling.
    """
    it = itertools.permutations(range(n_within), n_subjects)
    out = list(itertools.islice(it, n_group))
    if len(out) < n_group:
        # the reference dies with a bare StopIteration here
        # (permutation_testing.py:504-506); same bound, clearer error
        raise ValueError(
            f"n_permutations_group_level={n_group} exceeds the "
            f"{len(out)} distinct group permutations available with "
            f"{n_within} within-subject permutations over {n_subjects} "
            "subject(s); raise n_permutations_per_subject or lower the "
            "group count"
        )
    return np.array(out, dtype=np.int32)


def p_values_from_null_max(observed: np.ndarray, null_max_sorted: np.ndarray) -> np.ndarray:
    """Per-vertex p-values via searchsorted into the sorted null max statistics.

    Parity with permutation_testing.py:328-346: only vertices with observed
    statistic > 0 get a p-value; p = 1 - rank/N with the top-rank clamp.
    """
    observed = np.asarray(observed)
    n = len(null_max_sorted)
    p = np.full(observed.shape, np.nan)
    pos = observed > 0
    idx = np.searchsorted(null_max_sorted, observed[pos])
    pv = 1.0 - idx / n
    pv[idx >= n] = 1.0 - (n - 1) / n
    p[pos] = pv
    return p


def significance_cutoff(null_max: np.ndarray, p_value_threshold: float = 0.05):
    """Quantile cutoff over per-permutation max statistics.

    Parity with cluster_analysis.py:155-178 (``method='closest_observation'``,
    exact-max shortcut when threshold == 1/N).
    """
    null_distr = np.sort(np.asarray(null_max))
    n = len(null_distr)
    if p_value_threshold == 1 / n:
        return float(np.max(null_distr)), null_distr
    cutoff = np.quantile(null_distr, 1 - p_value_threshold, method="closest_observation")
    return float(cutoff), null_distr
