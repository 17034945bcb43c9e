"""Example: ROI-restricted decoding via atlas annotations.

The port's counterpart of ``examples/roi_decoding.py``, the script form of
the reference's ROI-decoding notebook: derive a vertex mask from a
parcellation, run the whole-brain decoder restricted to it, and compare
against the unmasked decode (BASELINE config: "multi-model sweep ... with
ROI/atlas decoding").  The decoder runs on ``--device`` (default ``cuda``).

Run:  python -m multimodal_decoding_tpu_torch.examples.roi_decoding [--device cpu]
"""

import argparse
import os
import pickle
import tempfile

import numpy as np

from multimodal_decoding_tpu_torch import config
from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu_torch.decoding.whole_brain import WholeBrainConfig, run
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io.annot import read_annot, roi_mask_dict
from multimodal_decoding_tpu_torch.ops.metrics import ACC_CAPTIONS, ACC_IMAGES


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annot-lh", type=str, default=None)
    parser.add_argument("--annot-rh", type=str, default=None)
    parser.add_argument("--regions", nargs="+", default=None)
    parser.add_argument("--device", type=str, default="cuda", help="device of the decoder")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    tmp = tempfile.mkdtemp(prefix="mmd_roi_")
    info = make_synthetic_dataset(tmp, n_train=60, n_vertices=50, latent_dim=10)
    config.FMRI_STIM_INFO_DIR = info["stim_info_dir"]
    config.LATENT_FEATURES_DIR = info["features_dir"]
    config.BETAS_CACHE_DIR = os.path.join(tmp, "cache")

    if args.annot_lh:
        annots = {"left": read_annot(args.annot_lh), "right": read_annot(args.annot_rh)}
        mask = roi_mask_dict(annots, args.regions)
    else:
        # demo ROI: second half of the vertices on each hemisphere
        v = info["n_vertices"]
        half = np.zeros(v, dtype=np.uint8)
        half[v // 2:] = 1
        mask = {"left": half, "right": half}

    mask_path = os.path.join(tmp, "roi_mask.p")
    with open(mask_path, "wb") as f:
        pickle.dump(mask, f)

    results = run(WholeBrainConfig(
        betas_dir=info["betas_dir"], subjects=["sub-01"], models=[info["model"]],
        alphas=(1e0, 1e2), surface=True, masks=[None, mask_path],
        out_dir=os.path.join(tmp, "out"), device=device,
    ))
    for res in results:
        label = "ROI" if res["mask"] else "whole brain"
        print(f"{label}: {res['num_voxels']} vertices | "
              f"acc captions {res[ACC_CAPTIONS]:.3f} | images {res[ACC_IMAGES]:.3f}")


if __name__ == "__main__":
    main()
