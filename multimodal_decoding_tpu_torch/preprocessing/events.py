"""Event-file handling: GLM condition naming + behavioural QC.

Copy of ``multimodal_decoding_tpu/preprocessing/events.py``,
its imports pointed at the port.

Rebuilds the event-tsv stages of the reference:
* condition-name derivation for the SPM design
  (the reference's preprocessing/make_spm_design_job_mat.py:22-55): each
  stimulus event becomes ``<split>_<modality>_<id>``, imagery events
  ``imagery_<n>``, plus one-back repeats and fixation/blank nuisance events;
* one-back behavioural error rates
  (the reference's analyses/supplementary/event_file_analysis.py:11-54).
"""

from __future__ import annotations

import numpy as np


def condition_name(trial_type: str, split: str | None, modality: str | None, stim_id) -> str:
    """SPM condition name for one event (make_spm_design_job_mat.py:22-55 vocabulary)."""
    if trial_type == "one_back":
        return "one_back"
    if trial_type == "fixation" or trial_type == "blank":
        return "blank"
    if split == "imagery":
        return f"imagery_{stim_id}"
    return f"{split}_{modality}_{stim_id}"


def concatenated_run_onsets(events_per_run: list, run_durations: list) -> list:
    """Shift per-run onsets into one concatenated timeline
    (make_spm_design_job_mat.py:58-76)."""
    out = []
    offset = 0.0
    for events, duration in zip(events_per_run, run_durations):
        shifted = [dict(e, onset=float(e["onset"]) + offset) for e in events]
        out.extend(shifted)
        offset += float(duration)
    return out


def one_back_error_rates(events: list) -> dict:
    """Behavioural QC: hit/miss/false-alarm rates for the one-back task
    (event_file_analysis.py:11-54 semantics).

    ``events`` is a list of dicts with keys trial_type ('stimulus'/'one_back'
    repeats marked), response (bool).  A 'one_back' event with response=True
    is a hit; response on a non-repeat is a false alarm.
    """
    hits = misses = false_alarms = n_repeats = n_stims = 0
    for e in events:
        if e.get("trial_type") == "one_back":
            n_repeats += 1
            if e.get("response"):
                hits += 1
            else:
                misses += 1
        elif e.get("trial_type") == "stimulus":
            n_stims += 1
            if e.get("response"):
                false_alarms += 1
    return {
        "hit_rate": hits / n_repeats if n_repeats else np.nan,
        "miss_rate": misses / n_repeats if n_repeats else np.nan,
        "false_alarm_rate": false_alarms / n_stims if n_stims else np.nan,
        "n_repeats": n_repeats,
        "n_stimuli": n_stims,
    }


def framewise_displacement(motion_params: np.ndarray, head_radius: float = 50.0) -> np.ndarray:
    """FD from 6 realignment parameters [T, 6] (plot_dataset_quality_stats QC):
    sum of absolute backward differences, rotations scaled by head radius."""
    mp = np.asarray(motion_params, dtype=np.float64)
    diffs = np.abs(np.diff(mp, axis=0))
    diffs[:, 3:] *= head_radius
    return np.concatenate([[0.0], diffs.sum(axis=1)])
