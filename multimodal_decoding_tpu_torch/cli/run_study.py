"""CLI: full-study orchestration in one command, on a GPU.

Port of ``multimodal_decoding_tpu/cli/run_study.py`` with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, and without
a GPU the run stops rather than falling back).  It drives
``decoding.study.run_study``: all training modes' null searchlights, then
group permutation stats + TFCE significance, with the same idempotent
skip/resume behaviour at every stage.  ``--fast-math`` runs the
searchlights on bf16 storage at one bf16 pass, as ``run_searchlight``'s.
Started by ``torchrun`` (``WORLD_SIZE`` > 1) both stages split their work
over the ranks of the world, one process per GPU; rank 0 writes.

    python -m multimodal_decoding_tpu_torch.cli.run_study \\
        --betas-dir <betas>/surface --mesh-dir <surfaces> --model imagebind \\
        --l2-regularization-alpha cv --searchlight-out-dir <sl out> \\
        --permutation-out-dir <perm out>
"""

import argparse
import os

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    FMRI_BETAS_SURFACE_DIR,
    FS_HEMI_NAMES,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    SELECT_DEFAULT,
    SUBJECTS,
    SURFACE_MESH_DIR,
    TRAINING_MODES,
)
from multimodal_decoding_tpu_torch.decoding.study import StudyConfig, run_study
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io.surface import read_freesurfer_geometry
from multimodal_decoding_tpu_torch.parallel.mesh import launched_world_size


def _alpha_key(value: str):
    if value == "cv":
        return value
    return float(value)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--betas-dir", type=str, default=FMRI_BETAS_SURFACE_DIR)
    p.add_argument("--mesh-dir", type=str, default=SURFACE_MESH_DIR)
    p.add_argument("--model", type=str, default=DEFAULT_MODEL)
    p.add_argument("--features", type=str, default=SELECT_DEFAULT)
    p.add_argument("--subjects", type=str, nargs="+", default=SUBJECTS)
    p.add_argument("--training-modes", type=str, nargs="+",
                   default=list(TRAINING_MODES))
    p.add_argument("--hemis", type=str, nargs="+", default=["left", "right"])
    p.add_argument("--resolution", type=str, default=DEFAULT_RESOLUTION)
    p.add_argument("--l2-regularization-alpha", type=_alpha_key, default=1.0,
                   help="fixed alpha, or 'cv' for per-vertex alpha-CV")
    p.add_argument("--n-neighbors", type=int, default=750)
    p.add_argument("--radius", type=float, default=None)
    p.add_argument("--n-permutations-per-subject", type=int, default=100)
    p.add_argument("--n-permutations-group-level", type=int, default=10000)
    p.add_argument("--p-value-threshold", type=float, default=1e-4)
    p.add_argument("--metric", type=str, default=METRIC_MOD_AGNOSTIC_AND_CROSS)
    p.add_argument("--tfce-h", type=float, default=2.0)
    p.add_argument("--tfce-e", type=float, default=1.0)
    p.add_argument("--tfce-dh", type=float, default=0.1)
    p.add_argument("--searchlight-out-dir", type=str, default=None)
    p.add_argument("--permutation-out-dir", type=str, default=None)
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--fast-math", action="store_true", default=False,
                   help="bfloat16 X_all storage and every searchlight product at one "
                        "bf16 pass (precision 'default')")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to run on (default cuda; no CPU fallback)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.n_neighbors is None and args.radius is None:
        raise RuntimeError("Need to set either radius or n_neighbors arg!")
    resolve_device(args.device)  # no GPU and no --device cpu: stop before any work
    meshes = {
        hemi: read_freesurfer_geometry(
            os.path.join(args.mesh_dir, args.resolution,
                         f"{FS_HEMI_NAMES[hemi]}.inflated")
        )
        for hemi in args.hemis
    }
    if args.radius is not None:
        args.n_neighbors = None  # mutually exclusive, radius wins like the CLIs
    stats = run_study(StudyConfig(
        betas_dir=args.betas_dir,
        meshes=meshes,
        model=args.model,
        features=args.features,
        subjects=args.subjects,
        training_modes=args.training_modes,
        hemis=args.hemis,
        resolution=args.resolution,
        l2_regularization_alpha=args.l2_regularization_alpha,
        n_neighbors=args.n_neighbors,
        radius=args.radius,
        n_permutations_per_subject=args.n_permutations_per_subject,
        n_permutations_group_level=args.n_permutations_group_level,
        p_value_threshold=args.p_value_threshold,
        metric=args.metric,
        tfce_h=args.tfce_h,
        tfce_e=args.tfce_e,
        tfce_dh=args.tfce_dh,
        searchlight_out_dir=args.searchlight_out_dir,
        permutation_out_dir=args.permutation_out_dir,
        block_size=args.block_size,
        fast_math=args.fast_math,
        mesh="auto" if launched_world_size() > 1 else None,
        device=args.device,
    ))
    for hemi, p_vals in stats["p_values"].items():
        n_sig = int((p_vals < args.p_value_threshold).sum())
        print(f"{hemi}: {n_sig} significant vertices "
              f"(cutoff {float(stats['significance_cutoff']):.4g})")
    return stats


if __name__ == "__main__":
    main()
