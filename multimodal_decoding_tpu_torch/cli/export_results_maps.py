"""CLI: export searchlight accuracy maps as gifti.

Copy of ``multimodal_decoding_tpu/cli/export_results_maps.py``,
its imports pointed at the port.

Mirrors the reference's analyses/decoding/searchlight/
searchlight_results_maps.py: per-subject + subject-averaged maps for the
analysis metric vocabulary, min-composite maps, and the n-neighbours map
(radius mode).
"""

import argparse
import os

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    METRIC_CROSS_DECODING,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
)
from multimodal_decoding_tpu_torch.cli.permutation_testing import (
    add_searchlight_permutation_args,
)
from multimodal_decoding_tpu_torch.decoding.permutation import (
    PermutationConfig,
    load_per_subject_scores,
)
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.ops.stats import COMPOSITE_METRICS, T_VAL_METRICS
from multimodal_decoding_tpu_torch.viz.maps import export_average_maps, export_subject_maps

ACC_COMPOSITES = {
    # accuracy-space min composites (searchlight_results_maps.py:114-154)
    "min_" + METRIC_MOD_AGNOSTIC_AND_CROSS: COMPOSITE_METRICS[METRIC_MOD_AGNOSTIC_AND_CROSS],
    "min_" + METRIC_CROSS_DECODING: COMPOSITE_METRICS[METRIC_CROSS_DECODING],
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser = add_searchlight_permutation_args(parser)
    parser.add_argument("--searchlight-out-dir", type=str, default=None)
    parser.add_argument("--out-dir", type=str, required=True)
    args = parser.parse_args(argv)

    cfg = PermutationConfig(
        subjects=args.subjects, model=args.model, features=args.features,
        test_features=args.test_features, vision_features=args.vision_features,
        lang_features=args.lang_features,
        mod_specific_images_model=args.mod_specific_images_model,
        mod_specific_images_features=args.mod_specific_images_features,
        mod_specific_images_test_features=args.mod_specific_images_test_features,
        mod_specific_captions_model=args.mod_specific_captions_model,
        mod_specific_captions_features=args.mod_specific_captions_features,
        mod_specific_captions_test_features=args.mod_specific_captions_test_features,
        l2_regularization_alpha=args.l2_regularization_alpha,
        resolution=args.resolution, radius=args.radius, n_neighbors=args.n_neighbors,
        searchlight_out_dir=args.searchlight_out_dir,
    )
    per_subject = load_per_subject_scores(cfg)
    metrics = [m for m in T_VAL_METRICS
               if all(m in per_subject[s]["left"] for s in cfg.subjects)]
    os.makedirs(args.out_dir, exist_ok=True)
    written = export_subject_maps(per_subject, metrics, args.out_dir)
    written += export_average_maps(per_subject, metrics, args.out_dir,
                                   min_composites=ACC_COMPOSITES)
    print(f"wrote {len(written)} gifti maps under {args.out_dir}")


if __name__ == "__main__":
    main()
