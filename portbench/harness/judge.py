"""The comparison that decides ``correct``: the program's answers against the
plain reference's, as numbers, each held to the limit its traffic file
gives it.

An answer that is not a finite number counts as the widest gap there is.
"""

from __future__ import annotations

import numpy as np


def _gaps(got, ref) -> np.ndarray:
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    gap = np.abs(got - ref)
    return np.where(np.isfinite(gap), gap, np.inf)


def searchlight(got: dict, ref: dict, comparisons: dict) -> dict:
    """Numbers of a sample of vertices: ``got`` and ``ref`` hold ``alpha``
    ([S] or None), ``scores`` {metric: [S]} and ``null`` {metric: [S, P]};
    ``comparisons`` is the number of pairwise comparisons each metric counts;
    with a CV grid ``ref`` also holds its mean CV scores ``cv`` [S, A] over
    ``alphas``.

    * ``alpha_regret`` (CV only): the most reference CV score a vertex gives
      up by the alpha ``got`` chose, against the reference's best (a float32
      near-tie in the CV scores decides some alphas, at no cost);
    * ``score_flips``: over the vertices whose alphas agree, the share of all
      the final scores' pairwise comparisons that come out otherwise, as the
      gaps of the accuracies times their comparisons over the comparisons (a
      comparison at a float32 near-tie moves an imagery accuracy by 1/6);
    * ``null_flips``: the same of the null scores, over vertices and shuffles.
    """
    agree = (np.ones(len(next(iter(ref["scores"].values()))), dtype=bool)
             if ref["alpha"] is None else np.asarray(got["alpha"]) == np.asarray(ref["alpha"]))
    out = {}
    if ref["alpha"] is not None:
        cv = np.asarray(ref["cv"], dtype=np.float64)
        picked = np.argmin(np.abs(np.log(np.asarray(got["alpha"], dtype=np.float64))[:, None]
                                  - np.log(np.asarray(ref["alphas"], dtype=np.float64))), axis=1)
        out["alpha_regret"] = float(np.max(cv.max(axis=1) - cv[np.arange(len(cv)), picked]))
    for key, name in (("scores", "score"), ("null", "null")):
        gaps = {m: _gaps(got[key][m], ref[key][m])[agree] for m in ref[key]}
        flipped = sum(float(g.sum()) * comparisons[m] for m, g in gaps.items())
        total = sum(g.size * comparisons[m] for m, g in gaps.items())
        out[f"{name}_flips"] = flipped / total if total else float("inf")
    return out


def whole_brain(pairs: list) -> dict:
    """Numbers of the checked decodes, each a (program, reference) pair of
    dicts with ``alpha``, ``cv_scores`` [A], ``test_preds``, ``imagery_preds``
    and ``scores`` {metric: value}.

    * ``cv_gap``: the widest gap of a CV mean score, over decodes and alphas;
    * ``pred_gap``: the widest gap of a test or imagery prediction over the
      largest |prediction| of the reference, over decodes (a decode whose
      alpha differs predicts otherwise, and shows here; the scores are a
      function of the predictions).
    """
    return {
        "cv_gap": max(float(_gaps(g["cv_scores"], r["cv_scores"]).max()) for g, r in pairs),
        "pred_gap": max(float(_gaps(g[k], r[k]).max() / np.abs(r[k]).max())
                        for g, r in pairs for k in ("test_preds", "imagery_preds")),
    }


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number that has a limit is at most its limit;
    ``checks`` is {name: {"value": number, "limit": limit}} for those."""
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in limits.items()
              if k in numbers}
    missing = [k for k in limits if k not in numbers]
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
