"""Result artifact helpers: score-map containers & reference-pickle interop.

The reference stores searchlight scores as a numpy object array of ~163k
per-vertex dicts (searchlight.py:149,287) — convenient for joblib, terrible
for tensors.  This framework's canonical form is a dict-of-arrays
{metric: [V]}; these converters keep result pickles interchangeable with
reference consumers (searchlight_permutation_testing.py:63 indexes
``score[metric]`` per element).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def scores_to_list(scores: dict) -> np.ndarray:
    """{metric: [V]} -> object array of V per-vertex dicts (reference layout)."""
    metrics = list(scores.keys())
    v = len(scores[metrics[0]])
    out = np.empty(v, dtype=object)
    for i in range(v):
        out[i] = {m: scores[m][i] for m in metrics}
    return out


def list_to_scores(score_list) -> dict:
    """Object array / list of per-vertex dicts -> {metric: [V]} float arrays."""
    metrics = list(score_list[0].keys())
    return {m: np.array([s[m] for s in score_list], dtype=np.float32) for m in metrics}


def save_pickle(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_null_scores_npz(path: str, null_scores: dict) -> None:
    """Null distributions {metric: [V, P]} as one compressed npz.

    Replaces the reference's per-vertex pickle files (searchlight.py:79 —
    ~327k files per run) with a single artifact.
    """
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32) for k, v in null_scores.items()})


def load_null_scores_npz(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}
