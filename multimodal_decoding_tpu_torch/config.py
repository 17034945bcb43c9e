"""Typed configuration & experiment vocabulary.

Reproduces the reference's two-tier config system (constants in
reference utils.py:10-56 and reference data.py:14-314) as one
module with environment-variable overridable paths.  Run identity is encoded
into directory paths exactly like the reference (its de-facto experiment
database), so results written by this framework land in the same layout a
user of the reference expects.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Path registry (reference: utils.py:12-41).  Overridable via env vars so the
# framework is relocatable; defaults mirror the reference contract.
# ---------------------------------------------------------------------------

DATA_DIR = os.environ.get(
    "MMD_DATA_DIR", os.path.expanduser("~/data/multimodal_decoding")
)

COCO_IMAGES_DIR = os.environ.get("MMD_COCO_DIR", os.path.expanduser("~/data/coco/"))

LATENT_FEATURES_DIR = os.path.join(DATA_DIR, "nn_features")

RESULTS_FILE = "results.p"

FMRI_DATA_DIR = os.path.join(DATA_DIR, "fmri")
FMRI_STIM_INFO_DIR = os.path.join(FMRI_DATA_DIR, "stim_info")

FMRI_BIDS_DATA_DIR = os.path.join(FMRI_DATA_DIR, "bids")
STIM_INFO_PATH = os.path.join(FMRI_BIDS_DATA_DIR, "stimuli", "stimuli.csv")
FMRI_BETAS_DIR = os.path.join(FMRI_BIDS_DATA_DIR, "derivatives", "betas")
FMRI_BETAS_SURFACE_DIR = os.path.join(FMRI_BETAS_DIR, "surface")

RIDGE_DECODER_OUT_DIR = os.path.join(DATA_DIR, "whole_brain_decoding/")
SEARCHLIGHT_OUT_DIR = os.path.join(DATA_DIR, "searchlight")
SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR = os.path.join(
    SEARCHLIGHT_OUT_DIR, "permutation_testing_results"
)

# Device-friendly cache of betas (first load converts gifti -> npy).
BETAS_CACHE_DIR = os.path.join(DATA_DIR, "betas_cache")

# Surface mesh directory: FreeSurfer fsaverage geometry files
# ({lh,rh}.inflated / .white) live here since nilearn fetching is unavailable.
SURFACE_MESH_DIR = os.environ.get(
    "MMD_SURFACE_DIR", os.path.join(DATA_DIR, "surfaces")
)

# ---------------------------------------------------------------------------
# Experiment vocabulary (reference: utils.py:43-56, data.py:14-25)
# ---------------------------------------------------------------------------

SUBJECTS = ["sub-01", "sub-02", "sub-03", "sub-04", "sub-05", "sub-07"]
HEMIS = ["left", "right"]
HEMIS_FS = ["lh", "rh"]
FS_HEMI_NAMES = {"left": "lh", "right": "rh"}

DEFAULT_MODEL = "imagebind"
DEFAULT_RESOLUTION = "fsaverage7"

# Number of vertices per hemisphere for the fsaverage family.
RESOLUTION_NUM_VERTICES = {
    "fsaverage3": 642,
    "fsaverage4": 2562,
    "fsaverage5": 10242,
    "fsaverage6": 40962,
    "fsaverage7": 163842,
    "fsaverage": 163842,
}

MODALITY_SPECIFIC_IMAGES = "images"
MODALITY_SPECIFIC_CAPTIONS = "captions"
MODALITY_AGNOSTIC = "agnostic"
TRAINING_MODES = [MODALITY_AGNOSTIC, MODALITY_SPECIFIC_CAPTIONS, MODALITY_SPECIFIC_IMAGES]

SPLIT_TRAIN = "train"
SPLIT_TEST = "test"
SPLIT_IMAGERY = "imagery"

IMAGE = "image"
CAPTION = "caption"
IMAGERY = "imagery"

# Composite metric names (reference: utils.py:52-56)
METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC = "diff_captions_agno_captions_specific"
METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC = "diff_imgs_agno_imgs_specific"
METRIC_DIFF_MOD_AGNOSTIC_MOD_SPECIFIC = "diff_mod_agno_mod_specific"
METRIC_CROSS_DECODING = "cross_decoding"
METRIC_MOD_AGNOSTIC_AND_CROSS = "mod_agnostic_and_cross"

# ---------------------------------------------------------------------------
# Feature combination vocabulary (reference: data.py:191-314)
# ---------------------------------------------------------------------------

AVG_FEATS = "avg"
LANG_FEATS_ONLY = "lang"
VISION_FEATS_ONLY = "vision"
FUSED_FEATS_CLS = "fused_cls"
FUSED_FEATS_MEAN = "fused_mean"
MATCHED_FEATS = "matched"
SELECT_DEFAULT = "default"

VISION_MEAN_FEAT_KEY = "vision_features_mean"
VISION_CLS_FEAT_KEY = "vision_features_cls"
LANG_MEAN_FEAT_KEY = "lang_features_mean"
LANG_CLS_FEAT_KEY = "lang_features_cls"
FUSED_MEAN_FEAT_KEY = "fused_mean_features"
FUSED_CLS_FEAT_KEY = "fused_cls_features"

FEATURE_COMBINATION_CHOICES = [
    AVG_FEATS,
    LANG_FEATS_ONLY,
    VISION_FEATS_ONLY,
    FUSED_FEATS_CLS,
    FUSED_FEATS_MEAN,
    MATCHED_FEATS,
    SELECT_DEFAULT,
]

VISION_FEAT_COMBINATION_CHOICES = [VISION_MEAN_FEAT_KEY, VISION_CLS_FEAT_KEY, SELECT_DEFAULT]
LANG_FEAT_COMBINATION_CHOICES = [LANG_MEAN_FEAT_KEY, LANG_CLS_FEAT_KEY, SELECT_DEFAULT]

FEATS_NA = "n_a"

# Per-model default feature selection tables (reference: data.py:217-314).
DEFAULT_FEATURES = {
    "siglip": AVG_FEATS,
    "paligemma2": AVG_FEATS,
    "clip": AVG_FEATS,
    "imagebind": AVG_FEATS,
    "random-imagebind": AVG_FEATS,
    "flava": AVG_FEATS,
    "blip2": AVG_FEATS,
    "visualbert": FUSED_FEATS_MEAN,
    "vilt": FUSED_FEATS_MEAN,
    "bridgetower": FUSED_FEATS_CLS,
    "bert-base-uncased": LANG_FEATS_ONLY,
    "bert-large-uncased": LANG_FEATS_ONLY,
    "llama2-7b": LANG_FEATS_ONLY,
    "llama2-13b": LANG_FEATS_ONLY,
    "mistral-7b": LANG_FEATS_ONLY,
    "mixtral-8x7b": LANG_FEATS_ONLY,
    "gpt2-small": LANG_FEATS_ONLY,
    "gpt2-medium": LANG_FEATS_ONLY,
    "gpt2-large": LANG_FEATS_ONLY,
    "gpt2-xl": LANG_FEATS_ONLY,
    "vit-b-16": VISION_FEATS_ONLY,
    "vit-l-16": VISION_FEATS_ONLY,
    "vit-h-14": VISION_FEATS_ONLY,
    "resnet-18": VISION_FEATS_ONLY,
    "resnet-50": VISION_FEATS_ONLY,
    "resnet-152": VISION_FEATS_ONLY,
    "dino-base": VISION_FEATS_ONLY,
    "dino-large": VISION_FEATS_ONLY,
    "dino-giant": VISION_FEATS_ONLY,
    "gabor": MATCHED_FEATS,
}

DEFAULT_VISION_FEATURES = {
    "siglip": VISION_CLS_FEAT_KEY,
    "paligemma2": VISION_MEAN_FEAT_KEY,
    "clip": VISION_CLS_FEAT_KEY,
    "imagebind": VISION_CLS_FEAT_KEY,
    "random-imagebind": VISION_CLS_FEAT_KEY,
    "flava": VISION_CLS_FEAT_KEY,
    "blip2": VISION_CLS_FEAT_KEY,
    "visualbert": FEATS_NA,
    "vilt": FEATS_NA,
    "bridgetower": FEATS_NA,
    "bert-base-uncased": FEATS_NA,
    "bert-large-uncased": FEATS_NA,
    "llama2-7b": FEATS_NA,
    "llama2-13b": FEATS_NA,
    "mistral-7b": FEATS_NA,
    "mixtral-8x7b": FEATS_NA,
    "gpt2-small": FEATS_NA,
    "gpt2-medium": FEATS_NA,
    "gpt2-large": FEATS_NA,
    "gpt2-xl": FEATS_NA,
    "vit-b-16": VISION_MEAN_FEAT_KEY,
    "vit-l-16": VISION_MEAN_FEAT_KEY,
    "vit-h-14": VISION_MEAN_FEAT_KEY,
    "resnet-18": VISION_MEAN_FEAT_KEY,
    "resnet-50": VISION_MEAN_FEAT_KEY,
    "resnet-152": VISION_MEAN_FEAT_KEY,
    "dino-base": VISION_MEAN_FEAT_KEY,
    "dino-large": VISION_MEAN_FEAT_KEY,
    "dino-giant": VISION_MEAN_FEAT_KEY,
    "gabor": VISION_CLS_FEAT_KEY,
}

DEFAULT_LANG_FEATURES = {
    "siglip": LANG_CLS_FEAT_KEY,
    "paligemma2": LANG_MEAN_FEAT_KEY,
    "clip": LANG_CLS_FEAT_KEY,
    "imagebind": LANG_CLS_FEAT_KEY,
    "random-imagebind": LANG_CLS_FEAT_KEY,
    "flava": LANG_CLS_FEAT_KEY,
    "blip2": LANG_CLS_FEAT_KEY,
    "visualbert": FEATS_NA,
    "vilt": FEATS_NA,
    "bridgetower": FEATS_NA,
    "bert-base-uncased": LANG_MEAN_FEAT_KEY,
    "bert-large-uncased": LANG_MEAN_FEAT_KEY,
    "llama2-7b": LANG_MEAN_FEAT_KEY,
    "llama2-13b": LANG_MEAN_FEAT_KEY,
    "mistral-7b": LANG_MEAN_FEAT_KEY,
    "mixtral-8x7b": LANG_MEAN_FEAT_KEY,
    "gpt2-small": LANG_MEAN_FEAT_KEY,
    "gpt2-medium": LANG_MEAN_FEAT_KEY,
    "gpt2-large": LANG_MEAN_FEAT_KEY,
    "gpt2-xl": LANG_MEAN_FEAT_KEY,
    "vit-b-16": FEATS_NA,
    "vit-l-16": FEATS_NA,
    "vit-h-14": FEATS_NA,
    "resnet-18": FEATS_NA,
    "resnet-50": FEATS_NA,
    "resnet-152": FEATS_NA,
    "dino-base": FEATS_NA,
    "dino-large": FEATS_NA,
    "dino-giant": FEATS_NA,
    "gabor": LANG_CLS_FEAT_KEY,
}


@dataclass
class LatentFeatsConfig:
    """Resolves 'default' feature selections per model.

    Parity with the reference dataclass (data.py:317-338): the combined_feats
    string is part of the results-path contract.
    """

    model: str
    features: str = SELECT_DEFAULT
    test_features: str = SELECT_DEFAULT
    vision_features: str = SELECT_DEFAULT
    lang_features: str = SELECT_DEFAULT
    verbose: bool = True
    combined_feats: str = field(init=False)

    def __post_init__(self):
        if self.features == SELECT_DEFAULT:
            self.features = DEFAULT_FEATURES[self.model]
        if self.test_features == SELECT_DEFAULT:
            self.test_features = DEFAULT_FEATURES[self.model]
        if self.vision_features == SELECT_DEFAULT:
            self.vision_features = DEFAULT_VISION_FEATURES[self.model]
        if self.lang_features == SELECT_DEFAULT:
            self.lang_features = DEFAULT_LANG_FEATURES[self.model]
        if self.verbose:
            print(
                f"Selected features for {self.model}: {self.features} "
                f"{self.test_features} {self.vision_features} {self.lang_features}"
            )
        self.combined_feats = f"{self.features}_test_{self.test_features}"


def model_features_file_path(model_name: str) -> str:
    """Path of a model's extracted-feature pickle (reference: utils.py:63-64)."""
    return os.path.join(LATENT_FEATURES_DIR, f"{model_name.lower()}.p")


# Whole-brain ridge defaults (reference: ridge_regression_decoding.py:20-21)
NUM_CV_SPLITS = 5
DEFAULT_ALPHAS = (1e2, 1e3, 1e4, 1e5, 1e6, 1e7)
