"""Volume->surface transform stage: NaN-zeroing + FreeSurfer command builder.

Copy of ``multimodal_decoding_tpu/preprocessing/surface_transform.py``,
its imports pointed at the port.

Rebuild of the reference's preprocessing/transform_to_surface.py: verify the
beta directory contract against the hardcoded stimulus tables (:26-32 runtime
asserts — a data-contract check the build keeps), zero NaNs, and shell out to
FreeSurfer's ``mri_vol2surf`` per hemisphere.  The external binary stays
upstream (BASELINE north star: preprocessing untouched); command assembly is
a pure, testable function.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from multimodal_decoding_tpu_torch.config import FS_HEMI_NAMES, HEMIS, SPLIT_IMAGERY, SPLIT_TEST
from multimodal_decoding_tpu_torch.data.betas import get_fmri_data_paths
from multimodal_decoding_tpu_torch.data.stimuli import (
    IMAGERY_STIMS_IDS,
    IMAGERY_STIMS_TYPES,
    TEST_STIM_IDS,
    TEST_STIM_TYPES,
)
from multimodal_decoding_tpu_torch.io.nifti import read_nifti, write_nifti


def verify_beta_contract(betas_dir: str, subject: str) -> None:
    """Assert globbed test/imagery ids & types match the stimulus tables
    (transform_to_surface.py:26-32)."""
    _, test_ids, test_types = get_fmri_data_paths(betas_dir, subject, SPLIT_TEST)
    _, imag_ids, imag_types = get_fmri_data_paths(betas_dir, subject, SPLIT_IMAGERY)
    # the glob is image-then-caption ordered; ids within modality ascending:
    assert np.all(np.sort(test_ids[: len(TEST_STIM_IDS) // 2]) == np.sort(
        TEST_STIM_IDS[: len(TEST_STIM_IDS) // 2]
    ))
    assert set(test_types) == set(TEST_STIM_TYPES)
    assert np.all(imag_ids == IMAGERY_STIMS_IDS[subject])
    assert np.all(imag_types == IMAGERY_STIMS_TYPES[subject])


def zero_nans(path: str, betas_dir: str) -> str:
    """Write a NaN->0 copy under <betas_dir>/nan_to_zero/ (:40-49)."""
    img = read_nifti(path)
    data = np.asarray(img.get_fdata())
    data[np.isnan(data)] = 0
    out_path = path.replace(betas_dir, os.path.join(betas_dir, "nan_to_zero" + os.sep))
    assert out_path != path
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_nifti(out_path, data.astype(np.float32), descrip=img.descrip)
    return out_path


def vol2surf_command(mov_path: str, out_path: str, hemi: str, subject: str,
                     trg_subject: str = "fsaverage") -> str:
    """The exact mri_vol2surf invocation (:58-62)."""
    return (
        f"mri_vol2surf --mov {mov_path} --o {out_path} --hemi {FS_HEMI_NAMES[hemi]} "
        f"--trgsubject {trg_subject} --regheader {subject} "
        f"--interp trilinear --projfrac-avg 0 1 0.2"
    )


def recon_all_command(subject: str, nu_path: str) -> str:
    """recon-all wrapper command (recon_script.py:13 semantics)."""
    return f"recon-all -s {subject} -i {nu_path} -all"


def transform_betas_to_surface(betas_dir: str, subject: str, subjects_dir: str,
                               hemis=HEMIS, dry_run: bool = False) -> list:
    """Full stage: verify contract, NaN-zero each beta, vol2surf per hemi.

    Returns the command list (dry_run=True skips execution — used by tests;
    real runs need FreeSurfer on PATH and SUBJECTS_DIR populated).
    """
    verify_beta_contract(betas_dir, subject)
    env = dict(os.environ, SUBJECTS_DIR=subjects_dir)

    paths = []
    for split, mode in (("train", "agnostic"), ("test", "agnostic"), ("imagery", "agnostic")):
        p, _, _ = get_fmri_data_paths(betas_dir, subject, split, mode)
        paths += p

    commands = []
    for path in paths:
        zeroed = path if dry_run else zero_nans(path, betas_dir)
        for hemi in hemis:
            out_path = path.replace(
                betas_dir, os.path.join(betas_dir, "surface", hemi + os.sep)
            ).replace(".nii", ".gii")
            assert out_path != path
            cmd = vol2surf_command(zeroed, out_path, hemi, subject)
            commands.append(cmd)
            if not dry_run:
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                res = subprocess.run(cmd, shell=True, env=env, capture_output=True)
                if res.returncode != 0:
                    raise RuntimeError(f"failed to convert {path} to surface: {res.stderr}")
    return commands
