"""Publication figure CLI: TFCE-thresholded composites with aparc ROI contours.

Rebuild of the reference's analyses/visualization/searchlight_plot_results.py
(:37-296): for each result metric, load the permutation-testing artifacts
(t/tfce pickles + null max distribution via calc_test_statistics' idempotent
cache), derive the significance cutoff, and render the hemisphere x view
composite with the hot positive-only colormap and lightseagreen aparc ROI
contours.  Also emits the method panels (searchlight_plot_method.py family)
with --method-panels.

Usage:
  python -m multimodal_decoding_tpu_torch.cli.plot_results \\
      --mesh-dir ~/surfaces --annot-dir ~/labels --out-dir ~/figures

Same flags as the JAX package's CLI, plus ``--device`` (default ``cuda``):
the test statistics it may have to compute (calc_test_statistics) run there;
the figures are drawn on the host.
"""

from __future__ import annotations

import argparse
import os

from multimodal_decoding_tpu_torch.config import (
    FS_HEMI_NAMES,
    HEMIS,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR,
    SURFACE_MESH_DIR,
)
from multimodal_decoding_tpu_torch.ops.metrics import ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC
from multimodal_decoding_tpu_torch.cli.permutation_testing import (
    add_searchlight_permutation_args,
)
from multimodal_decoding_tpu_torch.decoding.permutation import (
    PermutationConfig,
    calc_test_statistics,
    load_per_subject_scores,
)
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io.annot import read_annot
from multimodal_decoding_tpu_torch.io.surface import edge_lengths, read_freesurfer_geometry
from multimodal_decoding_tpu_torch.viz.figures import plot_method_panels, plot_tfce_composite

# default figure metrics (searchlight_plot_results.py:32 METRICS)
DEFAULT_FIGURE_METRICS = [
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC,
]


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser = add_searchlight_permutation_args(parser)
    parser.add_argument("--n-permutations-group-level", type=int, default=10000)
    parser.add_argument("--p-value-threshold", type=float, default=1e-4)
    parser.add_argument("--tfce-value-threshold", type=float, default=None)
    parser.add_argument("--mesh-dir", type=str, default=SURFACE_MESH_DIR)
    parser.add_argument("--annot-dir", type=str, default=None,
                        help="dir with {lh,rh}.aparc.annot for ROI contours "
                             "(omit to render without contours)")
    parser.add_argument("--figure-metrics", type=str, nargs="+",
                        default=DEFAULT_FIGURE_METRICS)
    parser.add_argument("--views", type=str, nargs="+",
                        default=["lateral", "medial", "ventral"])
    parser.add_argument("--method-panels", action="store_true", default=False)
    parser.add_argument("--method-figures", action="store_true", default=False,
                        help="render the published method-figure classes "
                             "(per-view panel tree + composite, "
                             "searchlight_plot_method.py:42-393)")
    parser.add_argument("--searchlight-out-dir", type=str, default=None)
    parser.add_argument("--out-dir", type=str,
                        default=SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default cuda; no CPU fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    resolve_device(args.device)  # no GPU and no --device cpu: stop before any work
    mesh_by_hemi = {}
    edges_by_hemi = {}
    for hemi in HEMIS:
        mesh = read_freesurfer_geometry(
            os.path.join(args.mesh_dir, args.resolution, f"{FS_HEMI_NAMES[hemi]}.inflated")
        )
        mesh_by_hemi[hemi] = mesh
        edges_by_hemi[hemi] = edge_lengths(mesh)

    annot_by_hemi = None
    if args.annot_dir:
        annot_by_hemi = {
            hemi: read_annot(
                os.path.join(args.annot_dir, f"{FS_HEMI_NAMES[hemi]}.aparc.annot")
            )
            for hemi in HEMIS
        }

    fig_dir = os.path.join(args.out_dir, "figures")
    written = []
    per_subject = None
    for metric in args.figure_metrics:
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
            metric=metric,
            n_permutations_group_level=args.n_permutations_group_level,
            p_value_threshold=args.p_value_threshold,
            tfce_value_threshold=args.tfce_value_threshold,
            edges_by_hemi=edges_by_hemi,
            searchlight_out_dir=args.searchlight_out_dir,
            out_dir=args.out_dir,
            device=args.device,
        )
        stats = calc_test_statistics(cfg)
        cutoff = stats["significance_cutoff"]
        print(f"{metric} significance cutoff: {cutoff}")
        written.append(plot_tfce_composite(
            mesh_by_hemi, stats["tfce_values"], metric, cutoff, fig_dir,
            annot_by_hemi=annot_by_hemi, views=tuple(args.views),
        ))
        if per_subject is None and (args.method_panels or args.method_figures):
            # multi-GB unpickle at fsaverage7, metric-INDEPENDENT (the loader
            # only reads subject/model/feature fields) — load once, serve
            # both flags across every metric of the loop
            per_subject = load_per_subject_scores(cfg)
        if args.method_panels:
            written += plot_method_panels(
                mesh_by_hemi, per_subject, stats["t_values"], stats["tfce_values"],
                stats["p_values"], metric, os.path.join(fig_dir, "method"),
            )
        if args.method_figures:
            from multimodal_decoding_tpu_torch.viz.figures import plot_method_figures

            out = plot_method_figures(
                mesh_by_hemi, per_subject, stats["t_values"], stats["tfce_values"],
                stats["p_values"], metric, cutoff, args.p_value_threshold,
                fig_dir, views=tuple(args.views),
            )
            written.append(out["composite"])
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
