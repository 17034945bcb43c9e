"""Example: multi-model whole-brain decoding comparison.

The port's counterpart of ``examples/model_comparison.py``, the script form
of the reference's modality_agnostic_decoding notebook: decode with several
latent models, aggregate results into the long-form DataFrame, summarize
per-model accuracies.  Runs end-to-end on a synthetic dataset so it works
without real fMRI data; point ``--betas-dir`` at a real tree to use it in
production.  The decoder runs on ``--device`` (default ``cuda``: the CV
selection through the hand-written panel kernel); the summary needs pandas.

Run:  python -m multimodal_decoding_tpu_torch.examples.model_comparison [--device cpu]
"""

import argparse
import os
import tempfile

from multimodal_decoding_tpu_torch import config
from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu_torch.decoding.whole_brain import WholeBrainConfig, run
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.ops.metrics import ACC_CAPTIONS, ACC_IMAGES


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--betas-dir", type=str, default=None,
                        help="real dataset root; default: synthetic demo")
    parser.add_argument("--models", nargs="+", default=["clip"])
    parser.add_argument("--device", type=str, default="cuda", help="device of the decoder")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from multimodal_decoding_tpu_torch.viz.reporting import load_results_frame, summarize

    if args.betas_dir is None:
        tmp = tempfile.mkdtemp(prefix="mmd_demo_")
        print(f"building synthetic dataset under {tmp}")
        info = make_synthetic_dataset(tmp, n_train=60, n_vertices=50, latent_dim=10)
        config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
        config.LATENT_FEATURES_DIR = info["features_dir"]
        config.BETAS_CACHE_DIR = os.path.join(tmp, "cache")
        betas_dir = info["betas_dir"]
        out_dir = os.path.join(tmp, "whole_brain")
        models = [info["model"]]
    else:
        betas_dir = args.betas_dir
        out_dir = config.RIDGE_DECODER_OUT_DIR
        models = args.models

    cfg = WholeBrainConfig(
        betas_dir=betas_dir, subjects=["sub-01"], models=models,
        alphas=(1e0, 1e2, 1e4), surface=True, out_dir=out_dir, device=device,
    )
    run(cfg)

    df = load_results_frame(out_dir)
    print("\nPer-model pairwise accuracy (captions):")
    print(summarize(df, ACC_CAPTIONS, by=("model",)))
    print("\nPer-model pairwise accuracy (images):")
    print(summarize(df, ACC_IMAGES, by=("model",)))


if __name__ == "__main__":
    main()
