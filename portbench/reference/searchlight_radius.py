"""The upstream radius-mode searchlight for a sample of vertices, written plainly.

Upstream's ``--radius`` (``searchlight.py:152-178``) takes each vertex's
neighbourhood from ``radius_neighbors_graph``: every vertex within the
radius, distances in float64.  Each vertex's ridge is then fitted on exactly
those columns of the betas, as in ``reference/searchlight.py``: no padding
to a common width and no mask.  Vertices with as many neighbours go to that
function together.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import searchlight as SL


def squared_distances(coords: np.ndarray, v: int, points: np.ndarray) -> np.ndarray:
    """Float64 squared distances from vertex ``v`` to ``points`` (indices)."""
    c = np.asarray(coords, dtype=np.float64)
    return ((c[points] - c[v]) ** 2).sum(axis=1)


def balls(coords: np.ndarray, verts: np.ndarray, radius: float, chunk: int = 16) -> list:
    """Each vertex of ``verts``: the indices (ascending) of every vertex whose
    float64 distance to it is at most ``radius``."""
    c = np.asarray(coords, dtype=np.float64)
    out = []
    for s in range(0, len(verts), chunk):
        q = c[np.asarray(verts[s:s + chunk])]
        d2 = ((q[:, None, :] - c[None, :, :]) ** 2).sum(axis=2)
        out.extend(np.nonzero(row <= radius * radius)[0] for row in d2)
    return out


def vertices(X_all: torch.Tensor, neighbourhoods: list, Y_train, Y_test, Y_imag, caption_rows,
             image_rows, shuffles, derangement_choices: torch.Tensor, alpha=None, alphas=None,
             n_splits: int = 5, chunk: int = 16) -> dict:
    """``reference/searchlight.vertices`` over neighbourhoods of any sizes:
    ``neighbourhoods`` is one index array a vertex; the result keeps their
    order."""
    sizes = np.array([len(n) for n in neighbourhoods])
    parts, order = [], []
    for k in np.unique(sizes):
        group = np.nonzero(sizes == k)[0]
        idx = torch.as_tensor(np.stack([neighbourhoods[i] for i in group]), device=X_all.device)
        parts.append(SL.vertices(
            X_all, idx, Y_train, Y_test, Y_imag, caption_rows, image_rows, shuffles,
            derangement_choices[torch.as_tensor(group, device=X_all.device)], alpha=alpha,
            alphas=alphas, n_splits=n_splits, chunk=chunk))
        order.append(group)
    back = np.argsort(np.concatenate(order))

    def cat(key):
        if parts[0][key] is None:
            return None
        return np.concatenate([p[key] for p in parts])[back]

    return {"alpha": cat("alpha"), "cv": cat("cv"),
            "scores": {m: np.concatenate([p["scores"][m] for p in parts])[back]
                       for m in parts[0]["scores"]},
            "null": {m: np.concatenate([p["null"][m] for p in parts])[back]
                     for m in parts[0]["null"]}}
