"""Cluster mask post-processing: OR-combination & manual corrections.

Copy of ``multimodal_decoding_tpu/decoding/cluster_postproc.py``,
its imports pointed at the port.

Rebuilds the reference's analyses/decoding/searchlight/combine_cluster_maps.py
(:23-41 — OR-combine pickled per-metric masks into one mask + gifti) and
searchlight_cluster_manual_corrections.py (:24-38 — zero out hand-picked
vertex ids to split touching clusters, then re-derive cluster artifacts).
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_decoding_tpu_torch.config import FS_HEMI_NAMES, HEMIS
from multimodal_decoding_tpu_torch.io import artifacts
from multimodal_decoding_tpu_torch.io.gifti import export_to_gifti


def combine_cluster_maps(mask_paths: list, out_path: str, hemis=HEMIS) -> dict:
    """OR-combine {hemi: [V]} mask pickles -> pickle + per-hemi gifti."""
    combined = None
    for path in mask_paths:
        mask = artifacts.load_pickle(path)
        if combined is None:
            combined = {h: np.zeros_like(np.asarray(mask[h]), dtype=np.float64) for h in hemis}
        for h in hemis:
            m = np.nan_to_num(np.asarray(mask[h], dtype=np.float64), nan=0.0)
            combined[h] = np.maximum(combined[h], (m > 0).astype(np.float64))
    artifacts.save_pickle(combined, out_path)
    for h in hemis:
        export_to_gifti(
            combined[h].astype(np.float32),
            out_path.replace(".p", f"_{FS_HEMI_NAMES[h]}.gii"),
        )
    return combined


def apply_manual_corrections(mask: dict, removals: dict) -> dict:
    """Zero out specific vertex ids per hemisphere ({hemi: [vertex ids]})."""
    out = {h: np.array(mask[h], copy=True) for h in mask}
    for hemi, vertex_ids in removals.items():
        out[hemi][np.asarray(vertex_ids, dtype=int)] = 0
    return out
