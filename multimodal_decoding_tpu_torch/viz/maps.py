"""Accuracy-map exports: per-subject & subject-averaged gifti score maps.

Copy of ``multimodal_decoding_tpu/viz/maps.py``,
its imports pointed at the port.

Rebuild of
the reference's analyses/decoding/searchlight/searchlight_results_maps.py:
scatter per-vertex scores onto full-vertex arrays, export gifti maps per
metric per subject plus subject averages and min-composite maps, and the
n-neighbours map + accuracy-vs-patch-size correlation.
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_decoding_tpu_torch.config import FS_HEMI_NAMES, HEMIS
from multimodal_decoding_tpu_torch.io.gifti import export_to_gifti


def scatter_full(values, nan_locations):
    out = np.full(len(nan_locations), np.nan, dtype=np.float64)
    out[~np.asarray(nan_locations)] = np.asarray(values)
    return out


def export_subject_maps(per_subject_scores: dict, metrics, out_dir: str,
                        hemis=HEMIS) -> list:
    """Per-subject gifti maps: {subject: {hemi: {metric: [V]}}} -> .gii files
    (searchlight_results_maps.py:78-112)."""
    written = []
    for subject, by_hemi in per_subject_scores.items():
        for hemi in hemis:
            for metric in metrics:
                vals = np.asarray(by_hemi[hemi][metric], dtype=np.float32)
                path = os.path.join(
                    out_dir, subject, f"{metric}_{FS_HEMI_NAMES[hemi]}.gii"
                )
                os.makedirs(os.path.dirname(path), exist_ok=True)
                export_to_gifti(vals, path)
                written.append(path)
    return written


def export_average_maps(per_subject_scores: dict, metrics, out_dir: str,
                        hemis=HEMIS, min_composites: dict | None = None) -> list:
    """Subject-averaged maps + min-composite maps
    (searchlight_results_maps.py:114-154)."""
    written = []
    subjects = list(per_subject_scores)
    for hemi in hemis:
        averaged = {}
        for metric in metrics:
            stack = np.stack(
                [np.asarray(per_subject_scores[s][hemi][metric]) for s in subjects]
            )
            averaged[metric] = np.nanmean(stack, axis=0)
            path = os.path.join(out_dir, "avg", f"{metric}_{FS_HEMI_NAMES[hemi]}.gii")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            export_to_gifti(averaged[metric].astype(np.float32), path)
            written.append(path)
        for name, members in (min_composites or {}).items():
            comp = np.nanmin(np.stack([averaged[m] for m in members]), axis=0)
            path = os.path.join(out_dir, "avg", f"{name}_{FS_HEMI_NAMES[hemi]}.gii")
            export_to_gifti(comp.astype(np.float32), path)
            written.append(path)
    return written


def export_n_neighbors_map(n_neighbors, nan_locations, hemi, out_dir: str) -> str:
    """Patch-size map (radius mode; searchlight_results_maps.py:34-53)."""
    full = scatter_full(n_neighbors, nan_locations)
    path = os.path.join(out_dir, f"n_neighbors_{FS_HEMI_NAMES[hemi]}.gii")
    os.makedirs(out_dir, exist_ok=True)
    export_to_gifti(full.astype(np.float32), path)
    return path


def acc_vs_patch_size_correlation(scores, n_neighbors) -> float:
    """Pearson correlation of accuracy with neighbourhood size
    (searchlight_results_maps.py:55-75)."""
    s = np.asarray(scores, dtype=np.float64)
    n = np.asarray(n_neighbors, dtype=np.float64)
    ok = ~(np.isnan(s) | np.isnan(n))
    return float(np.corrcoef(s[ok], n[ok])[0, 1])
