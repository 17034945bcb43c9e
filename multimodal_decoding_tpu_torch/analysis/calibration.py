"""Statistical calibration: t-cutoff Monte-Carlo + closed-form t CDFs.

Port of ``multimodal_decoding_tpu/analysis/calibration.py`` (the reference's
t_val_threshold.py:11-46 and t_value_simulations.py:9-29).  The Monte-Carlo
null runs on the device in chunks of permutations: one ``[C, S, L, D]`` and
one ``[C, S, P, D]`` draw per chunk, from the JAX package's keys
(``split(PRNGKey(seed), n_perms)``, then ``split(k, 2)`` per permutation,
latents from the first key and predictions from the second) through
``utils/threefry.normal_torch``, which gives ``jax.random.normal``'s bits.
So a seed gives the JAX package's null and cutoffs, up to float32 near-ties
of the cosine distances that the two packages round differently.  The draws
do not depend on the chunk size.  The t5 CDF helpers are copies.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.ops.metrics import pairwise_accuracy
from multimodal_decoding_tpu_torch.ops.stats import ttest_1samp_no_p
from multimodal_decoding_tpu_torch.utils import threefry

# permutations a device chunk: the production draw is 466,944 normals a
# permutation; threefry's int64 lanes and the float64 fused steps peak at ~83
# bytes a normal (19.3 GB of device memory at 500 on an H100 80GB, chip_smoke.py
# phase analyses), and the draws do not depend on the chunk
CHUNK = 500


def mean_accuracy(acc: torch.Tensor, denom: int) -> torch.Tensor:
    """``[..., S]`` accuracies ``count / denom`` -> their float32 mean over S,
    rounded as the JAX package's jitted step rounds ``jnp.mean``: XLA adds
    ``count * (1/denom)`` into the sum with one fused multiply-add a subject,
    in subject order, and multiplies the sum by the float32 ``1/S``."""
    counts = torch.round(acc.to(torch.float64) * denom)  # exact: acc = count * (1/denom)
    recip = float(np.float32(1.0) / np.float32(denom))
    total = torch.zeros(acc.shape[:-1], dtype=torch.float64, device=acc.device)
    for i in range(acc.shape[-1]):
        total = (counts[..., i] * recip + total).to(torch.float32).to(torch.float64)
    return total.to(torch.float32) * float(np.float32(1.0 / acc.shape[-1]))


def null_draws(n_perms: int = 10000, n_subjects: int = 6, n_latents: int = 73,
               n_preds: int = 3, dim: int = 1024, seed: int = 0, device=None):
    """The Monte-Carlo null: ``(accs [n_perms, S], t [n_perms], mean_acc
    [n_perms])`` as float32 numpy arrays, the t-values as drawn (NaN kept)."""
    dev = resolve_device(device)
    keys = threefry.split(threefry.prng_key(seed), n_perms)
    accs, t_vals, means = [], [], []
    for start in range(0, n_perms, CHUNK):
        ks = threefry.split_torch(keys[start:start + CHUNK], 2, dev)  # [C, 2, 2]
        latents = threefry.normal_torch(ks[:, 0], (n_subjects, n_latents, dim))
        preds = threefry.normal_torch(ks[:, 1], (n_subjects, n_preds, dim))
        acc = pairwise_accuracy(latents, preds)  # [C, S]
        del latents, preds
        accs.append(acc.cpu().numpy())
        t_vals.append(ttest_1samp_no_p(acc - 0.5, dim=1).cpu().numpy())
        means.append(mean_accuracy(acc, n_preds * n_latents - min(n_preds, n_latents))
                     .cpu().numpy())
    return np.concatenate(accs), np.concatenate(t_vals), np.concatenate(means)


def t_threshold_monte_carlo(
    n_perms: int = 10000,
    n_subjects: int = 6,
    n_latents: int = 73,
    n_preds: int = 3,
    dim: int = 1024,
    p_vals=(0.05, 1e-2, 1e-3, 1e-4),
    seed: int = 0,
    device=None,
):
    """Null t distribution for chance-level pairwise accuracy (t_val_threshold.py:11-46).

    Returns {p: (t_cutoff, min_mean_acc_above_cutoff)}.
    """
    _, t_vals, mean_accs = null_draws(n_perms, n_subjects, n_latents, n_preds, dim, seed,
                                      device)
    t_vals = np.where(np.isnan(t_vals) | np.isinf(t_vals), 0.0, t_vals)

    out = {}
    for thresh in p_vals:
        if thresh == 1 / n_perms:
            cutoff = float(np.max(t_vals))
        else:
            cutoff = float(np.quantile(t_vals, 1 - thresh, method="closest_observation"))
        above = mean_accs[t_vals > cutoff]
        out[thresh] = (cutoff, float(np.min(above)) if len(above) else np.nan)
    return out


def t5_cdf(t):
    """Closed-form Student-t CDF with 5 dof (t_value_simulations.py:9-10)."""
    t = np.asarray(t, dtype=np.float64)
    return 0.5 + (1 / np.pi) * (
        (t / (np.sqrt(5) * (1 + t**2 / 5))) * (1 + 2 / (3 * (1 + t**2 / 5)))
        + np.arctan(t / np.sqrt(5))
    )


def t5_min_of_two_cdf(t):
    """CDF of min of two independent t(5) variables (t_value_simulations.py:20-21)."""
    return 1 - (1 - t5_cdf(t)) ** 2


def t5_quantile(q: float, cdf=t5_cdf, lo=-50.0, hi=50.0, tol=1e-10) -> float:
    """Invert a monotone CDF by bisection (replaces the reference's linspace scan)."""
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if cdf(mid) < q:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2
