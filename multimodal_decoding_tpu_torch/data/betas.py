"""fMRI beta loading with the reference's directory/glob contracts.

Path contracts preserved verbatim from reference data.py:341-398 (betas
under ``<betas_dir>[/<hemi>]/<subject>/betas_<split>[_<modality>]/*.{nii,gii}``
with stim ids parsed from ``beta_<id>`` filenames) so a user can point this
framework at an existing dataset.  On top of the reference behaviour, loaded
arrays are cached as .npy in BETAS_CACHE_DIR: the reference re-parses
thousands of gifti XML files on every run (data.py:452-455, the IO hot loop);
the cache turns second loads into a single mmap-able read.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from glob import glob

import numpy as np

from multimodal_decoding_tpu_torch import config
from multimodal_decoding_tpu_torch.config import (
    CAPTION,
    IMAGE,
    IMAGERY,
    MODALITY_AGNOSTIC,
    MODALITY_SPECIFIC_CAPTIONS,
    MODALITY_SPECIFIC_IMAGES,
    SPLIT_IMAGERY,
    SPLIT_TEST,
    SPLIT_TRAIN,
)
from multimodal_decoding_tpu_torch.data.stimuli import (
    IMAGERY_SCENES,
    IMAGERY_STIMS_IDS,
    IMAGERY_STIMS_TYPES,
    TEST_STIM_IDS,
    TEST_STIM_TYPES,
)
from multimodal_decoding_tpu_torch.io.gifti import read_gifti
from multimodal_decoding_tpu_torch.io.nifti import read_nifti


def stim_id_from_beta_file_name(name: str, suffix: str = ".nii") -> int:
    return int(name.replace("beta_", "").replace(suffix, ""))


def get_fmri_data_paths(betas_dir, subject, split, mode=MODALITY_AGNOSTIC, hemi=None,
                        file_suffix=".nii"):
    """Glob betas + derive stim ids/types (parity: data.py:345-384).

    Note the reference's test-split ordering: image betas before caption betas
    (data.py:360-362) — the opposite of TEST_STIM_TYPES' caption-first layout.
    Kept as-is for bit-parity (benign for models whose caption/image features
    coincide, e.g. 'avg'-combined; see data.py:421-424).
    """
    base_path = os.path.join(betas_dir, subject) if hemi is None else os.path.join(
        betas_dir, hemi, subject
    )
    if split == SPLIT_TRAIN:
        if mode == MODALITY_SPECIFIC_CAPTIONS:
            mode_suffix = f"_{CAPTION}"
        elif mode == MODALITY_SPECIFIC_IMAGES:
            mode_suffix = f"_{IMAGE}"
        else:
            mode_suffix = "_*"
        pattern = os.path.join(base_path, f"betas_{split}{mode_suffix}", f"*{file_suffix}")
        paths = sorted(glob(pattern))
    elif split == SPLIT_IMAGERY:
        pattern = os.path.join(base_path, f"betas_{split}", f"*{file_suffix}")
        paths = sorted(glob(pattern))
    else:
        p1 = os.path.join(base_path, f"betas_{split}_{IMAGE}/", f"*{file_suffix}")
        p2 = os.path.join(base_path, f"betas_{split}_{CAPTION}/", f"*{file_suffix}")
        paths = sorted(glob(p1)) + sorted(glob(p2))

    stim_ids, stim_types = [], []
    for path in paths:
        split_name = path.split(os.sep)[-2]
        stim_id = stim_id_from_beta_file_name(os.path.basename(path), file_suffix)
        if IMAGERY in split_name:
            stim_types.append(IMAGERY)
            stim_id = IMAGERY_SCENES[subject][stim_id - 1][1]
        elif IMAGE in split_name:
            stim_types.append(IMAGE)
        elif CAPTION in split_name:
            stim_types.append(CAPTION)
        else:
            raise RuntimeError(f"Unknown split name: {split_name}")
        stim_ids.append(stim_id)

    return paths, np.array(stim_ids), np.array(stim_types)


def get_stim_info(subject, split):
    """Stim ids/types per split (parity: data.py:387-398)."""
    if split == SPLIT_TRAIN:
        with open(os.path.join(config.FMRI_STIM_INFO_DIR, f"{subject}_stim_ids_{split}.p"), "rb") as f:
            stim_ids = pickle.load(f)
        with open(os.path.join(config.FMRI_STIM_INFO_DIR, f"{subject}_stim_types_{split}.p"), "rb") as f:
            stim_types = pickle.load(f)
    elif split == SPLIT_TEST:
        stim_ids, stim_types = TEST_STIM_IDS, TEST_STIM_TYPES
    elif split == SPLIT_IMAGERY:
        stim_ids, stim_types = IMAGERY_STIMS_IDS[subject], IMAGERY_STIMS_TYPES[subject]
    else:
        raise RuntimeError(f"Unknown split name: {split}")
    return np.asarray(stim_ids), np.asarray(stim_types)


def _cache_path(kind, betas_dir, subject, split, mode, hemi):
    key = hashlib.sha1(
        "|".join(map(str, [os.path.abspath(betas_dir), subject, split, mode, hemi])).encode()
    ).hexdigest()[:16]
    return os.path.join(config.BETAS_CACHE_DIR, f"{kind}_{subject}_{split}_{mode}_{hemi}_{key}.npz")


def surface_cache_path(betas_dir, subject, split, mode=MODALITY_AGNOSTIC, hemi="left") -> str:
    """Public path of the surface-betas npz cache (streaming ingestion reads
    it directly via parallel/ingest.NpzMemberReader)."""
    return _cache_path("surf", betas_dir, subject, split, mode, hemi)


def get_fmri_surface_data(betas_dir, subject, split, mode=MODALITY_AGNOSTIC, hemi="left",
                          use_cache=True):
    """Load per-hemisphere surface betas [n_stim, V] (parity: data.py:448-458)."""
    cache = _cache_path("surf", betas_dir, subject, split, mode, hemi)
    if use_cache and os.path.isfile(cache):
        z = np.load(cache, allow_pickle=False)
        return z["betas"], z["stim_ids"], z["stim_types"]

    paths, stim_ids, stim_types = get_fmri_data_paths(
        betas_dir, subject, split, mode, hemi, file_suffix=".gii"
    )
    betas = np.array([read_gifti(p).darrays[0].data for p in paths])
    if use_cache and len(paths):
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, betas=betas, stim_ids=stim_ids, stim_types=stim_types)
    return betas, stim_ids, stim_types


def get_fmri_voxel_data(betas_dir, subject, split, mode=MODALITY_AGNOSTIC, use_cache=True):
    """Load volumetric betas flattened [n_stim, X*Y*Z] (parity: data.py:493-503)."""
    cache = _cache_path("vol", betas_dir, subject, split, mode, None)
    if use_cache and os.path.isfile(cache):
        z = np.load(cache, allow_pickle=False)
        return z["betas"], z["stim_ids"], z["stim_types"]

    paths, stim_ids, stim_types = get_fmri_data_paths(betas_dir, subject, split, mode)
    betas = np.array(
        [read_nifti(p).get_fdata().astype("float32").reshape(-1) for p in paths]
    )
    if use_cache and len(paths):
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, betas=betas, stim_ids=stim_ids, stim_types=stim_types)
    return betas, stim_ids, stim_types


def get_fmri_data(betas_dir, subject, split, mode=MODALITY_AGNOSTIC, surface=False,
                  use_cache=True):
    """Both-hemisphere (surface) or volumetric betas (parity: data.py:481-491)."""
    if surface:
        surf_dir = os.path.join(betas_dir, "surface")
        left, stim_ids, stim_types = get_fmri_surface_data(
            surf_dir, subject, split, mode, "left", use_cache
        )
        right, _, _ = get_fmri_surface_data(surf_dir, subject, split, mode, "right", use_cache)
        return np.hstack((left, right)), stim_ids, stim_types
    return get_fmri_voxel_data(betas_dir, subject, split, mode, use_cache)
