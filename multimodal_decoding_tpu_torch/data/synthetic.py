"""Synthetic dataset fabrication: fake betas + latents with real file contracts.

Serves the role of the reference's generative simulation
(reference analyses/supplementary/modeling_decoding.py:21-187) plus test
fixtures: builds an on-disk dataset (gifti surface betas / nifti volumes,
feature pickles, stim-info pickles) laid out exactly like the production
directory contract, with a planted linear brain->latent mapping so decoders
have real signal to find.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    CAPTION,
    IMAGE,
    LANG_CLS_FEAT_KEY,
    LANG_MEAN_FEAT_KEY,
    VISION_CLS_FEAT_KEY,
    VISION_MEAN_FEAT_KEY,
)
from multimodal_decoding_tpu_torch.data.stimuli import IDS_IMAGES_TEST, IMAGERY_STIMS_IDS
from multimodal_decoding_tpu_torch.io.gifti import write_gifti
from multimodal_decoding_tpu_torch.io.nifti import write_nifti


def make_feature_pickle(path, stim_ids, dim=16, seed=0, scale=1.0):
    """Write a {stim_id: {feature_key: vec}} pickle like the extractors do
    (feat_extraction_utils.py:90-105)."""
    rng = np.random.RandomState(seed)
    feats = {}
    for sid in stim_ids:
        base = rng.randn(dim).astype(np.float32) * scale
        feats[int(sid)] = {
            VISION_CLS_FEAT_KEY: base + 0.1 * rng.randn(dim).astype(np.float32),
            VISION_MEAN_FEAT_KEY: base + 0.1 * rng.randn(dim).astype(np.float32),
            LANG_CLS_FEAT_KEY: base + 0.1 * rng.randn(dim).astype(np.float32),
            LANG_MEAN_FEAT_KEY: base + 0.1 * rng.randn(dim).astype(np.float32),
        }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(feats, f)
    return feats


def make_synthetic_dataset(
    root: str,
    subject: str = "sub-01",
    n_train: int = 60,
    n_vertices: int = 40,
    latent_dim: int = 12,
    model: str = "clip",
    surface: bool = True,
    noise: float = 0.5,
    n_nan_vertices: int = 3,
    seed: int = 0,
    beta_seed: int | None = None,
    hemis: list | None = None,
    progress: bool = False,
):
    """Build a full synthetic dataset under ``root``.

    Returns a dict of config paths/values to point the pipeline at.  Betas
    are generated as ``latent @ G + noise`` per vertex group so the planted
    mapping is linearly decodable.  ``beta_seed`` varies the per-subject
    brain mapping/noise while ``seed`` keeps the (shared) feature pickle
    stable — call once per subject with distinct beta_seed for group-level
    fixtures.
    """
    rng = np.random.RandomState(seed if beta_seed is None else beta_seed)
    feat_rng_seed = seed
    betas_dir = os.path.join(root, "betas")
    stim_info_dir = os.path.join(root, "stim_info")
    features_dir = os.path.join(root, "nn_features")
    os.makedirs(stim_info_dir, exist_ok=True)

    # the test set is the fixed 70-id table (data.py:109-189): latents are
    # always assembled for all of TEST_STIM_IDS, so betas must cover them too
    test_ids = list(IDS_IMAGES_TEST)
    imagery_ids = IMAGERY_STIMS_IDS[subject]

    # train stimulus ids disjoint from test/imagery.  Order must match the
    # production glob: sorted over betas_train_*/ returns all caption betas
    # (ascending id) before all image betas — the stim-info pickles the
    # reference's preprocessing writes follow the same layout.
    n_cap_train = n_train // 2
    train_ids = (np.arange(n_train) + 1_000_000).tolist()
    train_types = [CAPTION] * n_cap_train + [IMAGE] * (n_train - n_cap_train)
    with open(os.path.join(stim_info_dir, f"{subject}_stim_ids_train.p"), "wb") as f:
        pickle.dump(np.array(train_ids), f)
    with open(os.path.join(stim_info_dir, f"{subject}_stim_types_train.p"), "wb") as f:
        pickle.dump(np.array(train_types), f)

    all_imagery = {sid for ids in IMAGERY_STIMS_IDS.values() for sid in ids}
    all_ids = sorted(set(train_ids) | set(test_ids) | all_imagery)
    feats = make_feature_pickle(
        os.path.join(features_dir, f"{model}.p"), all_ids, dim=latent_dim,
        seed=feat_rng_seed + 1,
    )

    # planted linear map latent -> betas
    G = rng.randn(latent_dim, n_vertices).astype(np.float32)

    def latent_of(sid):
        d = feats[int(sid)]
        return (d[VISION_CLS_FEAT_KEY] + d[LANG_CLS_FEAT_KEY]) / 2.0

    def beta_of(sid):
        b = latent_of(sid) @ G + noise * rng.randn(n_vertices).astype(np.float32)
        b = b.astype(np.float32)
        if n_nan_vertices:
            b[:n_nan_vertices] = np.nan  # medial wall
        return b

    def write_beta(dirname, idx_name, sid, hemi=None):
        if surface:
            base = os.path.join(betas_dir, "surface", hemi, subject, dirname)
            os.makedirs(base, exist_ok=True)
            write_gifti(os.path.join(base, f"beta_{idx_name}.gii"), beta_of(sid))
        else:
            base = os.path.join(betas_dir, subject, dirname)
            os.makedirs(base, exist_ok=True)
            write_nifti(
                os.path.join(base, f"beta_{idx_name}.nii"),
                beta_of(sid).reshape(n_vertices, 1, 1),
            )

    if hemis is None:
        hemis = ["left", "right"] if surface else [None]
    for hemi in hemis:
        # train: split by modality dir (betas_train_caption / betas_train_image)
        for i, (sid, st) in enumerate(zip(train_ids, train_types)):
            if progress and i % 1000 == 0:
                print(f"  betas {hemi}: {i}/{n_train} train", flush=True)
            write_beta(f"betas_train_{st}", f"{sid:010d}", sid, hemi)
        # test: both modality dirs, every test id in each
        for st in (IMAGE, CAPTION):
            for sid in test_ids:
                write_beta(f"betas_test_{st}", f"{sid:010d}", sid, hemi)
        # imagery: numbered 1..3, resolved via IMAGERY_SCENES (data.py:369-371)
        for i, sid in enumerate(imagery_ids):
            write_beta("betas_imagery", f"{i + 1}", sid, hemi)

    return {
        "betas_dir": betas_dir,
        "stim_info_dir": stim_info_dir,
        "features_dir": features_dir,
        "model": model,
        "subject": subject,
        "n_vertices": n_vertices,
        "latent_dim": latent_dim,
        "train_ids": train_ids,
        "test_ids": test_ids,
    }
