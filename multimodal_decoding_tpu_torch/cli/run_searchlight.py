"""CLI: surface searchlight decoding on a GPU.

Port of ``multimodal_decoding_tpu/cli/run_searchlight.py`` with the same
flags plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU,
and without a GPU the run stops rather than falling back).  Started by
``torchrun`` (``WORLD_SIZE`` > 1) it splits every vertex block over the
ranks of the world, one process per GPU, and rank 0 writes the artifacts.

    python -m multimodal_decoding_tpu_torch.cli.run_searchlight \\
        --betas-dir <betas>/surface --subjects sub-01 --model imagebind \\
        --n-neighbors 750 --l2-alphas 1e2 1e3 1e4 1e5 1e6 1e7 \\
        --create-null-distr --mesh-dir <surfaces> --out-dir <out>
    torchrun --nproc-per-node 4 -m multimodal_decoding_tpu_torch.cli.run_searchlight ...
"""

import argparse
import os

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    FEATURE_COMBINATION_CHOICES,
    FMRI_BETAS_SURFACE_DIR,
    FS_HEMI_NAMES,
    LANG_FEAT_COMBINATION_CHOICES,
    MODALITY_AGNOSTIC,
    SEARCHLIGHT_OUT_DIR,
    SELECT_DEFAULT,
    SUBJECTS,
    SURFACE_MESH_DIR,
    TRAINING_MODES,
    VISION_FEAT_COMBINATION_CHOICES,
)
from multimodal_decoding_tpu_torch.decoding.searchlight import SearchlightConfig, run
from multimodal_decoding_tpu_torch.io.surface import read_freesurfer_geometry
from multimodal_decoding_tpu_torch.parallel.mesh import launched_world_size


def load_mesh_coords(mesh_dir: str, resolution: str, hemis) -> dict:
    """Load inflated-mesh coordinates: <mesh_dir>/<resolution>/{lh,rh}.inflated."""
    coords = {}
    for hemi in hemis:
        path = os.path.join(mesh_dir, resolution, f"{FS_HEMI_NAMES[hemi]}.inflated")
        coords[hemi] = read_freesurfer_geometry(path).coordinates
    return coords


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--betas-dir", type=str, default=FMRI_BETAS_SURFACE_DIR)
    parser.add_argument("--training-modes", type=str, nargs="+",
                        default=[MODALITY_AGNOSTIC], choices=TRAINING_MODES)
    parser.add_argument("--model", type=str, default=DEFAULT_MODEL)
    parser.add_argument("--features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--test-features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--vision-features", type=str, default=SELECT_DEFAULT,
                        choices=VISION_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--lang-features", type=str, default=SELECT_DEFAULT,
                        choices=LANG_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--subjects", type=str, nargs="+", default=SUBJECTS)
    parser.add_argument("--resolution", type=str, default=DEFAULT_RESOLUTION)
    parser.add_argument("--hemis", type=str, nargs="+", default=["left", "right"])
    parser.add_argument("--l2-regularization-alpha", type=float, default=1)
    parser.add_argument("--l2-alphas", type=float, nargs="+", default=None,
                        help="enable per-vertex CV over this alpha grid")
    parser.add_argument("--radius", type=float, default=None)
    parser.add_argument("--n-neighbors", type=int, default=None)
    parser.add_argument("--create-null-distr", default=False, action="store_true")
    parser.add_argument("--n-permutations-per-subject", type=int, default=100)
    parser.add_argument("--block-size", type=int, default=None)
    parser.add_argument("--mesh-dir", type=str, default=SURFACE_MESH_DIR)
    parser.add_argument("--out-dir", type=str, default=SEARCHLIGHT_OUT_DIR)
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--fast-math", action="store_true", default=False,
                        help="bfloat16 X_all storage and the fit's and predictions' "
                             "products at one bf16 pass (precision 'default'); the "
                             "Cholesky solve and the scores stay float32, and the CV "
                             "selection (--l2-alphas) keeps its float32 settings")
    parser.add_argument("--adjacency-cache-dir", type=str, default="auto",
                        help="cache dir for the kNN/radius adjacency build; "
                             "'auto' = <out-dir>/.adjacency_cache, 'none' disables")
    parser.add_argument("--stream-ingest", type=str, default=None,
                        choices=["auto", "on", "off"],
                        help="stream the betas npz cache onto the device in O(chunk) "
                             "host memory: 'on' (the cache must exist), 'off' (eager "
                             "load), 'auto' (stream float32 caches over 2 GiB); "
                             "unset = env MMD_STREAM_INGEST, default auto")
    parser.add_argument("--strict-cv", action="store_true", default=False,
                        help="select alphas with the strict Cholesky solve and "
                             "cosine-distance scorer instead of the fast path")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default cuda; no CPU fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    coords = load_mesh_coords(args.mesh_dir, args.resolution, args.hemis)
    cfg = SearchlightConfig(
        betas_dir=args.betas_dir,
        mesh_coords=coords,
        model=args.model,
        features=args.features,
        test_features=args.test_features,
        vision_features=args.vision_features,
        lang_features=args.lang_features,
        subjects=args.subjects,
        training_modes=args.training_modes,
        hemis=args.hemis,
        resolution=args.resolution,
        l2_regularization_alpha=args.l2_regularization_alpha,
        alphas_cv=args.l2_alphas,
        radius=args.radius,
        n_neighbors=args.n_neighbors,
        create_null_distr=args.create_null_distr,
        n_permutations_per_subject=args.n_permutations_per_subject,
        block_size=args.block_size,
        out_dir=args.out_dir,
        overwrite=args.overwrite,
        fast_math=args.fast_math,
        fast_cv=not args.strict_cv,
        stream_ingest=args.stream_ingest,
        adjacency_cache_dir=(
            None if args.adjacency_cache_dir == "none"
            else os.path.join(args.out_dir, ".adjacency_cache")
            if args.adjacency_cache_dir == "auto" else args.adjacency_cache_dir),
        mesh="auto" if launched_world_size() > 1 else None,
        device=args.device,
    )
    return run(cfg)


if __name__ == "__main__":
    main()
