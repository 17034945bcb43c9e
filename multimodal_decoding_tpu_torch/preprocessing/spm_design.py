"""SPM first-level GLM design-job generation (.mat).

Copy of ``multimodal_decoding_tpu/preprocessing/spm_design.py``,
its imports pointed at the port.

Rebuild of the reference's preprocessing/make_spm_design_job_mat.py:178-310:
assemble the SPM ``fmri_spec`` batch-job struct (concatenated-run onsets,
per-condition regressors, run + 6 realignment nuisance regressors, AR(1),
128 s high-pass, explicit gray-matter mask) and save it with
``scipy.io.savemat`` for ``run_spm_glm.m`` (the MATLAB/SPM execution stays
upstream, per the BASELINE north star).
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.preprocessing.events import (
    concatenated_run_onsets,
    condition_name,
)


def build_conditions(events: list, duration_key: str = "duration") -> dict:
    """Group concatenated events into SPM conditions: {name: (onsets, durations)}."""
    conditions: dict = {}
    for e in events:
        name = condition_name(
            e.get("trial_type", "stimulus"), e.get("split"), e.get("modality"), e.get("stim_id")
        )
        onsets, durations = conditions.setdefault(name, ([], []))
        onsets.append(float(e["onset"]))
        durations.append(float(e.get(duration_key, 0.0)))
    return conditions


def build_nuisance_regressors(motion_params_per_run: list) -> np.ndarray:
    """Concatenate per-run [T, 6] realignment params + per-run indicator columns
    (make_spm_design_job_mat.py:140-175)."""
    n_runs = len(motion_params_per_run)
    blocks = []
    total_t = sum(len(m) for m in motion_params_per_run)
    offset = 0
    run_indicators = np.zeros((total_t, n_runs))
    for r, mp in enumerate(motion_params_per_run):
        mp = np.asarray(mp, dtype=np.float64)
        blocks.append(mp)
        run_indicators[offset : offset + len(mp), r] = 1.0
        offset += len(mp)
    motion = np.concatenate(blocks, axis=0)
    return np.concatenate([motion, run_indicators[:, :-1]], axis=1)  # last run = baseline


def make_spm_job(
    events_per_run: list,
    run_durations: list,
    motion_params_per_run: list,
    scans: list,
    mask_path: str,
    tr: float = 1.5,
    hpf: float = 128.0,
    out_dir: str = ".",
) -> dict:
    """The fmri_spec job dict (savemat-ready), reference field layout."""
    events = concatenated_run_onsets(events_per_run, run_durations)
    conditions = build_conditions(events)
    regressors = build_nuisance_regressors(motion_params_per_run)

    cond_structs = np.empty((len(conditions),), dtype=object)
    for i, (name, (onsets, durations)) in enumerate(sorted(conditions.items())):
        cond_structs[i] = {
            "name": name,
            "onset": np.asarray(onsets, dtype=np.float64).reshape(-1, 1),
            "duration": np.asarray(durations, dtype=np.float64).reshape(-1, 1),
            "tmod": 0.0,
            "pmod": np.empty((0,)),
            "orth": 1.0,
        }

    sess = {
        "scans": np.asarray(scans, dtype=object).reshape(-1, 1),
        "cond": cond_structs,
        "multi": np.asarray([""], dtype=object),
        "regress": {
            "name": np.asarray(
                [f"R{i + 1}" for i in range(regressors.shape[1])], dtype=object
            ),
            "val": regressors,
        },
        "multi_reg": np.asarray([""], dtype=object),
        "hpf": float(hpf),
    }

    job = {
        "matlabbatch": {
            "spm": {
                "stats": {
                    "fmri_spec": {
                        "dir": np.asarray([out_dir], dtype=object),
                        "timing": {
                            "units": "secs",
                            "RT": float(tr),
                            "fmri_t": 16.0,
                            "fmri_t0": 8.0,
                        },
                        "sess": sess,
                        "fact": np.empty((0,)),
                        "bases": {"hrf": {"derivs": np.zeros((1, 2))}},
                        "volt": 1.0,
                        "global": "None",
                        "mthresh": -np.inf,
                        "mask": np.asarray([mask_path], dtype=object),
                        "cvi": "AR(1)",
                    }
                }
            }
        }
    }
    return job


def save_spm_job(job: dict, path: str) -> None:
    from scipy.io import savemat

    savemat(path, job, long_field_names=True)
