"""Example: the full betas-in -> figure-out pipeline on synthetic data.

The port's counterpart of ``examples/full_pipeline.py``.  One command
exercises everything a reference user needs, end to end:

  1. fabricate a synthetic dataset in the production layout (3 subjects,
     planted signal, icosphere surface standing in for fsaverage),
  2. run the BASELINE searchlight config — per-vertex alpha CV — with null
     distributions, for the modality-agnostic AND both modality-specific
     decoders (all three feed the group stats),
  3. run group permutation testing (t-maps -> TFCE -> significance cutoff
     -> p-values -> cluster masks),
  4. render the published-figure class: the TFCE composite with ROI
     contours from a synthetic parcellation (host matplotlib).

Steps 2 and 3 run on ``--device`` (default ``cuda``, where the CV selection
runs the hand-written panel kernel through ``"schur-pallas"``).

Run:  python -m multimodal_decoding_tpu_torch.examples.full_pipeline
      [--workdir DIR] [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

SUBJECTS = ["sub-01", "sub-02", "sub-03"]


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "mmd_full_pipeline"))
    ap.add_argument("--n-train", type=int, default=40)
    ap.add_argument("--n-perms", type=int, default=6)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the searchlights and the group statistics")
    return ap.parse_args(argv)


def pipeline(wd: str, n_train: int, n_perms: int, device):
    """Steps 1-3; returns (mesh, permutation config, statistics)."""
    from multimodal_decoding_tpu_torch import config
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.io.surface import edge_lengths, icosphere

    # --- 1. synthetic dataset --------------------------------------------
    mesh = icosphere(subdivisions=1, radius=50.0)
    for i, subj in enumerate(SUBJECTS):
        make_synthetic_dataset(
            wd, subject=subj, n_train=n_train, n_vertices=mesh.n_vertices,
            latent_dim=6, surface=True, beta_seed=300 + i, n_nan_vertices=1,
        )
    config.FMRI_STIM_INFO_DIR = os.path.join(wd, "stim_info")
    config.LATENT_FEATURES_DIR = os.path.join(wd, "nn_features")
    config.BETAS_CACHE_DIR = os.path.join(wd, "cache")
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle

    _load_feature_pickle.cache_clear()
    print(f"[1/4] synthetic dataset for {len(SUBJECTS)} subjects at {wd}")

    # --- 2. alpha-CV searchlights with null distributions ----------------
    from multimodal_decoding_tpu_torch.decoding.searchlight import SearchlightConfig, run

    coords = {"left": mesh.coordinates, "right": mesh.coordinates}
    sl_out = os.path.join(wd, "searchlight")
    for mode in ["agnostic", "images", "captions"]:
        run(SearchlightConfig(
            betas_dir=os.path.join(wd, "betas", "surface"),
            mesh_coords=coords, model="clip", subjects=SUBJECTS,
            training_modes=[mode], n_neighbors=6,
            alphas_cv=[0.5, 50.0], create_null_distr=True,
            n_permutations_per_subject=n_perms,
            out_dir=sl_out, progress=False, block_size=8, device=device,
        ))
    print("[2/4] alpha-CV searchlights (3 training modes, null distributions) done")

    # --- 3. group permutation statistics ----------------------------------
    from multimodal_decoding_tpu_torch.decoding import permutation as PT

    edges, lens = edge_lengths(mesh)
    pcfg = PT.PermutationConfig(
        subjects=SUBJECTS, model="clip",
        mod_specific_images_model="clip", mod_specific_captions_model="clip",
        n_neighbors=6, l2_regularization_alpha="cv",
        n_permutations_group_level=10, p_value_threshold=0.2,
        edges_by_hemi={"left": (edges, lens), "right": (edges, lens)},
        searchlight_out_dir=sl_out, out_dir=os.path.join(wd, "permutation"),
        null_chunk=8, device=device,
    )
    out = PT.run(pcfg)
    stats = out["stats"] if "stats" in out else out
    print(f"[3/4] permutation stats: significance cutoff "
          f"{stats['significance_cutoff']:.2f}")
    return mesh, pcfg, stats


def figure(wd: str, mesh, pcfg, stats) -> str:
    """Step 4: the TFCE composite with ROI contours (host matplotlib)."""
    from multimodal_decoding_tpu_torch.io.annot import Annotation
    from multimodal_decoding_tpu_torch.viz.figures import plot_tfce_composite

    z = mesh.coordinates[:, 2]
    idx = np.digitize(z, np.quantile(z, [0.34, 0.67]))
    colors = np.array([[25, 5, 25], [60, 20, 220], [220, 60, 20]], dtype=np.int64)
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    annot = Annotation(labels=packed[idx], names=["unknown", "dorsal", "ventral"],
                       ctab=np.column_stack([colors, np.zeros(3, np.int64), packed]))
    fig = plot_tfce_composite(
        {"left": mesh, "right": mesh}, stats["tfce_values"], pcfg.metric,
        stats["significance_cutoff"], os.path.join(wd, "figures"),
        annot_by_hemi={"left": annot, "right": annot},
        rois_for_view={"left": {"lateral": ["dorsal"], "medial": ["ventral"]},
                       "right": {"lateral": ["dorsal"], "medial": []}},
        views=("lateral", "medial"),
    )
    print(f"[4/4] figure written: {fig}")
    return fig


def main(argv=None):
    from multimodal_decoding_tpu_torch.device import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    mesh, pcfg, stats = pipeline(args.workdir, args.n_train, args.n_perms, device)
    figure(args.workdir, mesh, pcfg, stats)


if __name__ == "__main__":
    main()
