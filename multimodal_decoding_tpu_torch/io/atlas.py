"""Volumetric-atlas -> surface projection & quality metrics.

Copy of ``multimodal_decoding_tpu/io/atlas.py``,
its imports pointed at the port.

Rebuilds the reference's analyses/visualization/create_subcortical_atlas.py
(:25-60 — sample a labelled volume at surface vertex coordinates to create a
surface annotation) and the intersession-alignment QC from
notebooks (nipype Similarity / mutual information between session volumes).
"""

from __future__ import annotations

import numpy as np


def sample_volume_at_vertices(volume: np.ndarray, affine: np.ndarray,
                              vertex_coords: np.ndarray) -> np.ndarray:
    """Nearest-voxel sampling of a (label) volume at RAS vertex coordinates.

    ``affine`` maps voxel indices -> world (RAS) mm; vertices outside the
    volume get 0.
    """
    inv = np.linalg.inv(affine)
    homog = np.concatenate(
        [vertex_coords, np.ones((len(vertex_coords), 1))], axis=1
    )
    ijk = (homog @ inv.T)[:, :3]
    ijk = np.round(ijk).astype(int)
    out = np.zeros(len(vertex_coords), dtype=volume.dtype)
    ok = np.all((ijk >= 0) & (ijk < np.asarray(volume.shape)), axis=1)
    idx = ijk[ok]
    out[ok] = volume[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def volume_labels_to_annot(volume: np.ndarray, affine: np.ndarray,
                           vertex_coords: np.ndarray, label_names: dict,
                           out_path: str | None = None):
    """Create a surface annotation from a volumetric label atlas.

    ``label_names``: {volume label value: region name}.  Returns
    (labels [V] packed values, names, colors); optionally writes a .annot.
    """
    from multimodal_decoding_tpu_torch.io.annot import write_annot

    sampled = sample_volume_at_vertices(volume, affine, vertex_coords)
    values = sorted(label_names)
    names = ["unknown"] + [label_names[v] for v in values]
    rng = np.random.RandomState(0)
    colors = np.concatenate(
        [[[25, 25, 25, 0]], rng.randint(1, 255, size=(len(values), 4))]
    )
    colors[:, 3] = 0
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    labels = np.full(len(vertex_coords), packed[0], dtype=np.int64)
    for i, v in enumerate(values):
        labels[sampled == v] = packed[i + 1]
    if out_path:
        write_annot(out_path, labels, names, colors)
    return labels, names, colors


def mutual_information(x: np.ndarray, y: np.ndarray, bins: int = 64) -> float:
    """MI between two aligned images (intersession alignment QC; the
    reference shells out to nipype's Similarity node)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    ok = np.isfinite(x) & np.isfinite(y)
    hist, _, _ = np.histogram2d(x[ok], y[ok], bins=bins)
    pxy = hist / hist.sum()
    px = pxy.sum(axis=1, keepdims=True)
    py = pxy.sum(axis=0, keepdims=True)
    nz = pxy > 0
    return float(np.sum(pxy[nz] * np.log(pxy[nz] / (px @ py)[nz])))


def normalized_mutual_information(x: np.ndarray, y: np.ndarray, bins: int = 64) -> float:
    """NMI = (H(x) + H(y)) / H(x, y)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    ok = np.isfinite(x) & np.isfinite(y)
    hist, _, _ = np.histogram2d(x[ok], y[ok], bins=bins)
    pxy = hist / hist.sum()
    px, py = pxy.sum(axis=1), pxy.sum(axis=0)

    def entropy(p):
        p = p[p > 0]
        return -np.sum(p * np.log(p))

    return float((entropy(px) + entropy(py)) / max(entropy(pxy.ravel()), 1e-12))
