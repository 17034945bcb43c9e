"""Standardizers with NaN-column handling (parity with data.py:506-537).

Betas standardisation drops NaN columns (medial-wall vertices / out-of-brain
voxels) based on the FIRST train row, then applies a train-fit StandardScaler
to train/test/imagery.  Latent standardisation is a plain train-fit scaler.
It runs once per subject on host-resident arrays, so it stays numpy
(bit-parity with sklearn); a copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np


def _fit_scaler(train: np.ndarray):
    mean = train.mean(axis=0)
    std = train.std(axis=0)  # ddof=0, sklearn semantics
    scale = np.where(std == 0.0, 1.0, std)
    return mean, scale


def standardize_latents(train_latents, test_latents, imagery_latents=None):
    """Train-fit scaler applied to all splits (data.py:506-515)."""
    mean, scale = _fit_scaler(np.asarray(train_latents, dtype=np.float64))
    out = [
        ((np.asarray(a, dtype=np.float64) - mean) / scale).astype(np.float32)
        for a in (train_latents, test_latents)
    ]
    if imagery_latents is not None:
        out.append(
            ((np.asarray(imagery_latents, dtype=np.float64) - mean) / scale).astype(np.float32)
        )
        return tuple(out)
    return tuple(out)


def nan_column_locations(train_betas: np.ndarray) -> np.ndarray:
    """Boolean mask of NaN columns, judged from the first train sample (data.py:520)."""
    return np.isnan(np.asarray(train_betas)[0])


def standardize_fmri_betas(train_betas, test_betas, imagery_betas=None, return_nan_locations=False):
    """Drop NaN columns (first-row judged) then train-fit scale (data.py:518-537).

    Mirrors sklearn's StandardScaler on float32 input: statistics
    accumulate in float64 (``dtype=np.float64`` reductions — no float64
    COPY of the data; bit-identical to the scaler's f64 ``mean_``/
    ``scale_``, verified) while the transform runs in-place on the
    float32 arrays with the statistics rounded to f32 — exactly what
    modern sklearn does (1.9: ``X -= xp.astype(self.mean_, X.dtype)``;
    element-wise equality verified against StandardScaler in
    tests/test_preprocess.py).  Older sklearn applied the f64 operands
    directly, which differs by at most 1 ulp per element — well inside
    the 1e-4 parity gate either way.  The previous whole-array float64
    upcast tripled peak host memory at fsaverage7 scale (the
    [8192, 163839] train block alone is 5.4 GB f32 / 10.7 GB f64) for
    LESS fidelity to the installed sklearn.
    """
    train_betas = np.asarray(train_betas)
    nan_locations = nan_column_locations(train_betas)
    keep = ~nan_locations

    train = np.ascontiguousarray(train_betas[:, keep], dtype=np.float32)
    mean64 = train.mean(axis=0, dtype=np.float64)
    std64 = np.sqrt(np.var(train, axis=0, dtype=np.float64))
    scale64 = np.where(std64 == 0.0, 1.0, std64)
    mean32 = mean64.astype(np.float32)
    scale32 = scale64.astype(np.float32)

    def transform(x):
        x = np.ascontiguousarray(np.asarray(x)[:, keep], dtype=np.float32)
        x -= mean32
        x /= scale32
        return x

    train -= mean32
    train /= scale32
    outs = [train, transform(test_betas)]
    if imagery_betas is not None:
        outs.append(transform(imagery_betas))

    if return_nan_locations:
        return (*outs, nan_locations)
    return tuple(outs)


def apply_mask(mask: dict | None, betas_list: list, hemis=("left", "right")) -> list:
    """Restrict surface betas to mask==1 vertices (data.py:564-574).

    ``mask`` is a {hemi: [V] array} dict (the reference loads it from pickle);
    concatenated across hemispheres like the reference.
    """
    if mask is None:
        return betas_list
    mask_flat = np.concatenate([mask[h] for h in hemis])
    return [betas[:, mask_flat == 1].copy() for betas in betas_list]
