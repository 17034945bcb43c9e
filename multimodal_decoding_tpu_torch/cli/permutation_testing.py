"""CLI: group-level permutation testing on a GPU.

Port of ``multimodal_decoding_tpu/cli/permutation_testing.py`` with the same
flags (and the shared ``add_searchlight_permutation_args`` argument set)
plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, and
without a GPU the run stops rather than falling back).  Mesh edges come from
FreeSurfer geometry under ``--mesh-dir``.  ``--sharded`` splits the group
null over the ranks of the world (``parallel/mesh.vertex_mesh``): one
process per GPU under ``torchrun``, a world of one without it.  Started by
``torchrun`` the CLI shards with or without the flag; rank 0 writes.

    python -m multimodal_decoding_tpu_torch.cli.permutation_testing \\
        --subjects sub-01 sub-02 sub-03 --model imagebind --n-neighbors 750 \\
        --l2-regularization-alpha cv --searchlight-out-dir <searchlight out> \\
        --mesh-dir <surfaces> --out-dir <out>
"""

import argparse
import os

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    FEATURE_COMBINATION_CHOICES,
    FS_HEMI_NAMES,
    LANG_FEAT_COMBINATION_CHOICES,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR,
    SELECT_DEFAULT,
    SUBJECTS,
    SURFACE_MESH_DIR,
    VISION_FEAT_COMBINATION_CHOICES,
)
from multimodal_decoding_tpu_torch.decoding.permutation import PermutationConfig, run
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io.surface import edge_lengths, read_freesurfer_geometry
from multimodal_decoding_tpu_torch.parallel.mesh import launched_world_size, vertex_mesh


def _alpha_key(value: str):
    """Argparse type: a float alpha or the literal 'cv' (alpha-CV artifacts)."""
    if value == "cv":
        return value
    return float(value)


def add_searchlight_permutation_args(parser):
    """The shared permutation-testing arguments (parity: permutation_testing.py:616-650)."""
    parser.add_argument("--subjects", type=str, nargs="+", default=SUBJECTS)
    parser.add_argument("--model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--test-features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--vision-features", type=str, default=SELECT_DEFAULT,
                        choices=VISION_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--lang-features", type=str, default=SELECT_DEFAULT,
                        choices=LANG_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--mod-specific-images-model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--mod-specific-images-features", type=str, default=SELECT_DEFAULT)
    parser.add_argument("--mod-specific-images-test-features", type=str, default=SELECT_DEFAULT)
    parser.add_argument("--mod-specific-captions-model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--mod-specific-captions-features", type=str, default=SELECT_DEFAULT)
    parser.add_argument("--mod-specific-captions-test-features", type=str,
                        default=SELECT_DEFAULT)
    parser.add_argument("--l2-regularization-alpha", type=_alpha_key, default=1,
                        help="fixed alpha of the searchlight run, or 'cv' for "
                             "per-vertex alpha-CV artifacts (alpha_cv.p)")
    parser.add_argument("--resolution", type=str, default=DEFAULT_RESOLUTION)
    parser.add_argument("--radius", type=float, default=None)
    parser.add_argument("--n-neighbors", type=int, default=None)
    parser.add_argument("--tfce-h", type=float, default=2.0)
    parser.add_argument("--tfce-e", type=float, default=1.0)
    parser.add_argument("--tfce-dh", type=float, default=0.1)
    parser.add_argument("--metric", type=str, default=METRIC_MOD_AGNOSTIC_AND_CROSS)
    return parser


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser = add_searchlight_permutation_args(parser)
    parser.add_argument("--n-permutations-group-level", type=int, default=10000)
    parser.add_argument("--p-value-threshold", type=float, default=1e-4)
    parser.add_argument("--tfce-value-threshold", type=float, default=None)
    parser.add_argument("--mesh-dir", type=str, default=SURFACE_MESH_DIR)
    parser.add_argument("--searchlight-out-dir", type=str, default=None)
    parser.add_argument("--out-dir", type=str,
                        default=SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR)
    parser.add_argument("--keep-null-maps", action="store_true", default=False)
    parser.add_argument("--sharded", action="store_true", default=False,
                        help="split the group null's permutations over the ranks of "
                             "the world (torchrun: one process per GPU; alone: one)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default cuda; no CPU fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: stop before any work
    device_mesh = (vertex_mesh(args.device) if args.sharded or launched_world_size() > 1
                   else None)
    edges_by_hemi = {}
    for hemi in ("left", "right"):
        mesh = read_freesurfer_geometry(
            os.path.join(args.mesh_dir, args.resolution, f"{FS_HEMI_NAMES[hemi]}.inflated")
        )
        edges_by_hemi[hemi] = edge_lengths(mesh)

    cfg = PermutationConfig(
        subjects=args.subjects,
        model=args.model,
        features=args.features,
        test_features=args.test_features,
        vision_features=args.vision_features,
        lang_features=args.lang_features,
        mod_specific_images_model=args.mod_specific_images_model,
        mod_specific_images_features=args.mod_specific_images_features,
        mod_specific_images_test_features=args.mod_specific_images_test_features,
        mod_specific_captions_model=args.mod_specific_captions_model,
        mod_specific_captions_features=args.mod_specific_captions_features,
        mod_specific_captions_test_features=args.mod_specific_captions_test_features,
        l2_regularization_alpha=args.l2_regularization_alpha,
        resolution=args.resolution,
        radius=args.radius,
        n_neighbors=args.n_neighbors,
        tfce_h=args.tfce_h,
        tfce_e=args.tfce_e,
        tfce_dh=args.tfce_dh,
        metric=args.metric,
        n_permutations_group_level=args.n_permutations_group_level,
        p_value_threshold=args.p_value_threshold,
        tfce_value_threshold=args.tfce_value_threshold,
        edges_by_hemi=edges_by_hemi,
        searchlight_out_dir=args.searchlight_out_dir,
        out_dir=args.out_dir,
        keep_null_maps=args.keep_null_maps,
        device=args.device,
    )
    return run(cfg, mesh=device_mesh)


if __name__ == "__main__":
    main()
