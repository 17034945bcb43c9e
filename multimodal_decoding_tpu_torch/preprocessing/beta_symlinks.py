"""Organise GLM beta files into split directories (data-layer contract producer).

Copy of ``multimodal_decoding_tpu/preprocessing/beta_symlinks.py``,
its imports pointed at the port.

Rebuild of the reference's preprocessing/create_symlinks_beta_files.py:23-56:
SPM writes one beta_NNNN.nii per regressor with the condition encoded in the
NIfTI ``descrip`` header (e.g. "...train_image_123456*bf(1)"); this renames/
symlinks them into the ``betas_<split>`` directories the data layer globs
(data.py:345-384).  Uses the framework's own NIfTI reader (io/nifti.py) for
the header parse.
"""

from __future__ import annotations

import os
from glob import glob

from multimodal_decoding_tpu_torch.io.nifti import read_nifti

SPLITS = ["train_image", "train_caption", "test_caption", "test_image", "imagery", "blank"]
SUFFIX = "*bf(1)"


def get_subdir(split_name: str, beta_dir: str) -> str:
    subdir = os.path.join(beta_dir, f"betas_{split_name}")
    os.makedirs(subdir, exist_ok=True)
    return subdir


def parse_beta_descrip(descrip: str):
    """-> (split_name, stim_id or None) from the SPM regressor description."""
    for split_name in SPLITS:
        if split_name in descrip:
            if split_name == "blank":
                return split_name, None
            stim_id = int(descrip.split(split_name)[1].replace(SUFFIX, "").replace("_", ""))
            return split_name, stim_id
    return None, None


def create_symlinks_for_beta_files(betas_dir: str, id_width: int = 6) -> int:
    """Symlink unstructured SPM betas into split dirs; duplicate-safe."""
    beta_paths = sorted(glob(os.path.join(betas_dir, "unstructured", "beta_*.nii")))

    all_slink_names: set = set()
    all_targets: set = set()
    for beta_path in beta_paths:
        descrip = read_nifti(beta_path).descrip
        split_name, stim_id = parse_beta_descrip(descrip)
        if split_name is None:
            continue
        if split_name == "blank":
            slink_name = os.path.join(get_subdir(split_name, betas_dir), "beta_blank.nii")
        else:
            slink_name = os.path.join(
                get_subdir(split_name, betas_dir), f"beta_{stim_id:0{id_width}d}.nii"
            )
        if slink_name in all_slink_names:
            raise RuntimeError(f"slink already defined: {slink_name}")
        all_slink_names.add(slink_name)
        rel = beta_path.replace(betas_dir, "")
        if not rel.startswith(os.sep):
            rel = os.sep + rel
        rel = ".." + rel
        if rel in all_targets:
            raise RuntimeError(f"link target already processed: {rel}")
        all_targets.add(rel)
        os.symlink(rel, slink_name)
    return len(all_slink_names)
