"""Latent (DNN embedding) feature assembly.

Parity with reference data.py:401-478: per-model pickled feature dicts
``{stim_id: {feature_key: vector}}`` are assembled into [n_stim, D] float32
matrices according to the feature-combination mode (avg / lang / vision /
fused_cls / fused_mean / matched).  A small in-process LRU avoids re-reading
the same model pickle for each of the three splits (the reference reloads it
every call, data.py:402-403).
"""

from __future__ import annotations

import functools
import pickle

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    AVG_FEATS,
    CAPTION,
    FUSED_CLS_FEAT_KEY,
    FUSED_FEATS_CLS,
    FUSED_FEATS_MEAN,
    FUSED_MEAN_FEAT_KEY,
    IMAGE,
    IMAGERY,
    LANG_CLS_FEAT_KEY,
    LANG_FEATS_ONLY,
    LANG_MEAN_FEAT_KEY,
    MATCHED_FEATS,
    MODALITY_AGNOSTIC,
    MODALITY_SPECIFIC_CAPTIONS,
    MODALITY_SPECIFIC_IMAGES,
    SPLIT_IMAGERY,
    SPLIT_TEST,
    VISION_CLS_FEAT_KEY,
    VISION_FEATS_ONLY,
    VISION_MEAN_FEAT_KEY,
)
from multimodal_decoding_tpu_torch import config
from multimodal_decoding_tpu_torch.data.betas import get_stim_info


@functools.lru_cache(maxsize=4)
def _load_feature_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def get_vision_feats(latent_vectors, stim_id, vision_features_mode):
    if vision_features_mode == VISION_MEAN_FEAT_KEY:
        return latent_vectors[stim_id][VISION_MEAN_FEAT_KEY]
    if vision_features_mode == VISION_CLS_FEAT_KEY:
        return latent_vectors[stim_id][VISION_CLS_FEAT_KEY]
    raise RuntimeError("Unknown vision feature choice: " + str(vision_features_mode))


def get_lang_feats(latent_vectors, stim_id, lang_features_mode):
    if lang_features_mode == LANG_MEAN_FEAT_KEY:
        return latent_vectors[stim_id][LANG_MEAN_FEAT_KEY]
    if lang_features_mode == LANG_CLS_FEAT_KEY:
        return latent_vectors[stim_id][LANG_CLS_FEAT_KEY]
    raise RuntimeError("Unknown lang feature choice: " + str(lang_features_mode))


def assemble_features(latent_vectors, stim_ids, stim_types, features, vision_features,
                      lang_features) -> np.ndarray:
    """Combine per-stimulus feature dicts by mode (parity: data.py:415-445)."""
    rows = []
    for i, stim_id in enumerate(stim_ids):
        if features == VISION_FEATS_ONLY:
            feats = get_vision_feats(latent_vectors, stim_id, vision_features)
        elif features == LANG_FEATS_ONLY:
            feats = get_lang_feats(latent_vectors, stim_id, lang_features)
        elif features == AVG_FEATS:
            v = get_vision_feats(latent_vectors, stim_id, vision_features)
            l = get_lang_feats(latent_vectors, stim_id, lang_features)
            feats = np.mean((l, v), axis=0)
        elif features == FUSED_FEATS_CLS:
            feats = latent_vectors[stim_id][FUSED_CLS_FEAT_KEY]
        elif features == FUSED_FEATS_MEAN:
            feats = latent_vectors[stim_id][FUSED_MEAN_FEAT_KEY]
        elif features == MATCHED_FEATS:
            st = stim_types[i]
            if st == CAPTION:
                feats = get_lang_feats(latent_vectors, stim_id, lang_features)
            elif st in (IMAGE, IMAGERY):
                feats = get_vision_feats(latent_vectors, stim_id, vision_features)
            else:
                raise RuntimeError(f"Unknown stim type: {st}")
        else:
            raise RuntimeError(f"Unknown feature selection/combination method: {features}")
        rows.append(feats)
    return np.array(rows, dtype=np.float32)


def get_latent_features(feats_config, subject, split, mode=MODALITY_AGNOSTIC) -> np.ndarray:
    """Latent matrix for (model, subject, split, mode) (parity: data.py:401-445)."""
    latent_vectors = _load_feature_pickle(config.model_features_file_path(feats_config.model))
    stim_ids, stim_types = get_stim_info(subject, split)
    stim_ids, stim_types = np.asarray(stim_ids), np.asarray(stim_types)

    if mode == MODALITY_SPECIFIC_CAPTIONS:
        sel = stim_types == CAPTION
        stim_ids, stim_types = stim_ids[sel], stim_types[sel]
    elif mode == MODALITY_SPECIFIC_IMAGES:
        sel = stim_types == IMAGE
        stim_ids, stim_types = stim_ids[sel], stim_types[sel]

    features = (
        feats_config.test_features if split in (SPLIT_TEST, SPLIT_IMAGERY) else feats_config.features
    )
    return assemble_features(
        latent_vectors, stim_ids, stim_types, features,
        feats_config.vision_features, feats_config.lang_features,
    )
