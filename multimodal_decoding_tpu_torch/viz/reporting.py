"""Results aggregation: whole-brain result pickles -> long-form DataFrame.

Copy of ``multimodal_decoding_tpu/viz/reporting.py``,
its imports pointed at the port.

Rebuild of the reference's notebooks/notebook_utils.py:204-277: glob all
``results.p`` under the decoder output tree, flatten into a tidy DataFrame
(one row per metric value), optionally recompute metrics offline from the
stored predictions (the checkpoint contract: predictions + latents are in
every results pickle).
"""

from __future__ import annotations

import os
import pickle
from glob import glob

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_FEATURES,
    DEFAULT_LANG_FEATURES,
    DEFAULT_VISION_FEATURES,
    FEATS_NA,
    RIDGE_DECODER_OUT_DIR,
)
from multimodal_decoding_tpu_torch.ops import metrics as M

NON_METRIC_KEYS = {
    "alpha", "model", "subject", "features", "test_features", "vision_features",
    "lang_features", "training_mode", "mask", "num_voxels", "stimulus_ids",
    "stimulus_types", "imagery_stimulus_ids", "predictions", "imagery_predictions",
    "latents", "imagery_latents", "surface", "resolution", "cv_mean_scores",
    "fit_seconds",
}


def load_results_frame(results_dir: str | None = None, recompute_metrics: bool = False,
                       standardize_predictions: bool = True, device=None):
    """All results pickles -> long-form pandas DataFrame (notebook_utils.py:204-262).

    ``recompute_metrics`` scores the stored predictions on ``device``
    (``None``: cuda).
    """
    import pandas as pd

    results_dir = results_dir or RIDGE_DECODER_OUT_DIR
    rows = []
    for path in sorted(glob(os.path.join(results_dir, "**", "results.p"), recursive=True)):
        with open(path, "rb") as f:
            res = pickle.load(f)

        if recompute_metrics and "predictions" in res:
            scores = M.calc_all_pairwise_accuracy_scores(
                res["latents"], res["predictions"], res["stimulus_types"],
                res.get("imagery_latents"), res.get("imagery_predictions"),
                standardize_predictions=standardize_predictions, device=device,
            )
            res = {**res, **{k: float(v) for k, v in scores.items()}}

        base = {k: res.get(k) for k in
                ("model", "subject", "training_mode", "features", "test_features",
                 "vision_features", "lang_features", "alpha", "num_voxels", "mask")}
        base["path"] = path
        for key, value in res.items():
            if key in NON_METRIC_KEYS or not np.isscalar(value):
                continue
            rows.append({**base, "metric": key, "value": float(value)})
    return pd.DataFrame(rows)


def filter_default_features(df):
    """Keep rows using each model's default feature selection
    (notebook_utils.py:265-277)."""
    def is_default(row):
        model = row["model"]
        if model not in DEFAULT_FEATURES:
            return False
        ok = row["features"] == DEFAULT_FEATURES[model]
        if DEFAULT_VISION_FEATURES[model] != FEATS_NA:
            ok &= row["vision_features"] == DEFAULT_VISION_FEATURES[model]
        if DEFAULT_LANG_FEATURES[model] != FEATS_NA:
            ok &= row["lang_features"] == DEFAULT_LANG_FEATURES[model]
        return bool(ok)

    return df[df.apply(is_default, axis=1)]


def summarize(df, metric: str, by=("model",)):
    """Mean/std/count per group for one metric, with datapoint verification
    (the notebook figure builders assert expected counts,
    notebook_utils.py:144-157)."""
    sub = df[df.metric == metric]
    return (
        sub.groupby(list(by))["value"]
        .agg(["mean", "std", "count"])
        .sort_values("mean", ascending=False)
    )
