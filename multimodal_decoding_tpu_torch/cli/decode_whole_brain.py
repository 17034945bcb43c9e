"""CLI: whole-brain ridge decoding on a GPU.

Port of ``multimodal_decoding_tpu/cli/decode_whole_brain.py`` with the same
flags and defaults plus ``--device`` (default ``cuda``; ``--device cpu`` runs
on the CPU, and without a GPU the run stops rather than falling back).
``--multichip`` feature-shards the gram over the ranks of the world
(``parallel/mesh.feature_mesh``): one process per GPU under ``torchrun``,
and a world of one without it.  Started by ``torchrun`` the CLI shards the
gram with or without the flag, and rank 0 writes ``results.p``.  The CV
selection runs the device's shipped solver (``default_wb_cv_solver``) at its
shipped precision (``ops/precision.default_cv_precision``).

    python -m multimodal_decoding_tpu_torch.cli.decode_whole_brain \\
        --betas-dir <betas> --subjects sub-01 --models imagebind --surface \\
        --out-dir <out>
    torchrun --nproc-per-node 4 -m multimodal_decoding_tpu_torch.cli.decode_whole_brain \\
        --multichip ...
"""

import argparse
import os

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_ALPHAS,
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    FEATURE_COMBINATION_CHOICES,
    FMRI_BETAS_DIR,
    LANG_FEAT_COMBINATION_CHOICES,
    MODALITY_AGNOSTIC,
    RIDGE_DECODER_OUT_DIR,
    SELECT_DEFAULT,
    SUBJECTS,
    TRAINING_MODES,
    VISION_FEAT_COMBINATION_CHOICES,
)
from multimodal_decoding_tpu_torch.decoding.whole_brain import WholeBrainConfig, run
from multimodal_decoding_tpu_torch.parallel.mesh import launched_world_size


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--betas-dir", type=str, default=FMRI_BETAS_DIR)
    parser.add_argument("--training-modes", type=str, nargs="+",
                        default=[MODALITY_AGNOSTIC], choices=TRAINING_MODES)
    parser.add_argument("--models", type=str, nargs="+", default=[DEFAULT_MODEL])
    parser.add_argument("--features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--test-features", type=str, default=SELECT_DEFAULT,
                        choices=FEATURE_COMBINATION_CHOICES)
    parser.add_argument("--vision-features", type=str, default=SELECT_DEFAULT,
                        choices=VISION_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--lang-features", type=str, default=SELECT_DEFAULT,
                        choices=LANG_FEAT_COMBINATION_CHOICES)
    parser.add_argument("--subjects", type=str, nargs="+", default=SUBJECTS)
    parser.add_argument("--l2-regularization-alphas", type=float, nargs="+",
                        default=list(DEFAULT_ALPHAS))
    parser.add_argument("--surface", action="store_true", default=False)
    parser.add_argument("--resolution", default=DEFAULT_RESOLUTION)
    parser.add_argument("--masks", nargs="+", type=str, default=[None])
    parser.add_argument("--multichip", action="store_true", default=False,
                        help="feature-shard the gram over the ranks of the world "
                             "(torchrun: one process per GPU; alone: a world of one)")
    parser.add_argument("--overwrite", action="store_true", default=False)
    parser.add_argument("--out-dir", type=str, default=RIDGE_DECODER_OUT_DIR)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default cuda; no CPU fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = WholeBrainConfig(
        betas_dir=args.betas_dir,
        training_modes=args.training_modes,
        subjects=args.subjects,
        models=args.models,
        features=args.features,
        test_features=args.test_features,
        vision_features=args.vision_features,
        lang_features=args.lang_features,
        alphas=tuple(args.l2_regularization_alphas),
        surface=args.surface,
        resolution=args.resolution,
        masks=args.masks,
        overwrite=args.overwrite,
        out_dir=args.out_dir,
        mesh="auto" if args.multichip or launched_world_size() > 1 else None,
        device=args.device,
    )
    return run(cfg)


if __name__ == "__main__":
    main()
