"""A hemisphere's searchlight inputs and results files, worked out plainly.

What the CLI's host path has to produce, from the benchmark's own files:

* ``X_all``: the train-fitted standardisation of every column the train
  betas keep (no NaN in their first row), in float32, rows train | test |
  imagery.  Each kept column's mean and population standard deviation
  (ddof 0; a standard deviation of 0 counts as 1) over all the train rows.
  ``entries`` reads the betas caches with ``np.load`` and gives the
  standardised values at the sampled rows and kept columns, in float64; with
  ``low`` it is the control, one precision down: the statistics accumulated
  in float32, the result rounded to bfloat16.
* the adjacency: each kept vertex's ``k`` nearest kept vertices (itself
  first), exact.  ``neighbour_misses`` holds a sampled vertex's row to the
  float64 brute force: every vertex nearer than the k-th distance is in it,
  none is farther, up to ``tolerance`` (relative), so that vertices tied at
  the k-th distance may stand for each other.
* the results pickle and ``null_distr.npz``: ``schema_faults`` counts the
  keys and shapes that differ from the study's schema.
"""

from __future__ import annotations

import numpy as np
import torch

# the keys of the study's results pickle (searchlight.py:181-296), each with
# the shape it holds: V vertices, V' kept ones, k neighbours
RESULTS_SHAPES = {"nan_locations": ("V",), "adjacency": ("V'", "k"), "distances": ("V'", "k"),
                  "scores": ("V'",)}
RESULTS_KEYS = ("nan_locations", "adjacency", "n_neighbors", "distances", "scores")


def load_betas(path: str) -> np.ndarray:
    """The ``betas`` member of a betas cache, whole."""
    with np.load(path, allow_pickle=False) as z:
        return z["betas"]


def train_statistics(train: np.ndarray, columns: np.ndarray, low: bool = False) -> tuple:
    """Mean and scale of ``train``'s ``columns`` over all its rows: float64,
    or accumulated in float32 with ``low``."""
    dtype = np.float32 if low else np.float64
    x = train[:, columns].astype(dtype)
    n = dtype(len(x))
    mean = x.sum(axis=0, dtype=dtype) / n
    std = np.sqrt(((x - mean) ** 2).sum(axis=0, dtype=dtype) / n)
    return mean, np.where(std == 0, dtype(1), std)


def entries(paths: tuple, kept: np.ndarray, rows: np.ndarray, columns: np.ndarray,
            low: bool = False) -> np.ndarray:
    """[R, C] float64: ``X_all`` at global ``rows`` (train | test | imagery)
    and kept ``columns`` (indices among the kept ones), from the betas caches
    at ``paths`` = (train, test, imagery)."""
    splits = [load_betas(p) for p in paths]
    vertices = np.flatnonzero(kept)[columns]
    mean, scale = train_statistics(splits[0], vertices, low)
    bounds = np.cumsum([0] + [len(s) for s in splits])
    picked = np.empty((len(rows), len(vertices)), dtype=mean.dtype)
    for i, r in enumerate(rows):
        s = int(np.searchsorted(bounds, r, side="right")) - 1
        picked[i] = splits[s][r - bounds[s], vertices]
    x = (picked - mean) / scale
    if low:
        x = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64).numpy()
    return x.astype(np.float64)


def neighbour_misses(coords: np.ndarray, kept: np.ndarray, adjacency: np.ndarray,
                     vertices: np.ndarray, k: int, tolerance: float) -> float:
    """Share of the sampled kept ``vertices`` whose row of ``adjacency``
    ([V', k], kept numbering) is not an exact ``k``-NN set among the kept
    vertices (all of its rows miss where its shape is not [V', k])."""
    points = np.asarray(coords, dtype=np.float64)[kept]
    adjacency = np.asarray(adjacency)
    if adjacency.shape != (len(points), k):
        return 1.0
    misses = 0
    for v in vertices:
        d = np.sqrt(((points - points[v]) ** 2).sum(axis=1))
        kth = np.partition(d, k - 1)[k - 1]
        row = adjacency[v].astype(np.int64)
        ok = (len(np.unique(row)) == k and row.min() >= 0 and row.max() < len(points)
              and np.all(d[row] <= kth * (1 + tolerance))
              and np.all(np.isin(np.flatnonzero(d < kth * (1 - tolerance)), row)))
        misses += not ok
    return misses / len(vertices)


def schema_faults(results, nulls: dict, n_vertices: int, n_kept: int, k: int,
                  main_metrics: list, null_metrics: list, n_permutations: int) -> int:
    """Keys and shapes of a results pickle (as read back) and of its
    ``null_distr.npz`` (as {name: array}) that differ from the schema: each
    missing key, each array of another shape, each per-vertex score entry
    whose metrics differ, and each null map that is not [V', P] float32."""
    if not isinstance(results, dict):
        return len(RESULTS_KEYS) + len(null_metrics)
    sizes = {"V": n_vertices, "V'": n_kept, "k": k}
    faults = sum(key not in results for key in RESULTS_KEYS)
    for key, dims in RESULTS_SHAPES.items():
        if key in results:
            faults += np.shape(results[key]) != tuple(sizes[d] for d in dims)
    if "scores" in results and len(results["scores"]):
        first = results["scores"][0]
        faults += not isinstance(first, dict) or set(first) != set(main_metrics)
    faults += results.get("n_neighbors") is not None  # k-NN mode: no per-vertex counts
    for m in null_metrics:
        x = nulls.get(m)
        faults += (x is None or np.shape(x) != (n_kept, n_permutations)
                   or np.asarray(x).dtype != np.float32)
    return int(faults) + len(set(nulls) - set(null_metrics))
