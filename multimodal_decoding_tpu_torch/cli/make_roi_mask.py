"""CLI: build ROI vertex masks from FreeSurfer annotations.

Copy of ``multimodal_decoding_tpu/cli/make_roi_mask.py``,
its imports pointed at the port.

Produces the {hemi: [V] mask} pickle the decoding pipelines consume via
--masks (data.py:564-574 apply_mask contract), from .annot parcellations
(HCP-MMP1 / Destrieux — the reference's atlas_data assets).

  python -m multimodal_decoding_tpu_torch.cli.make_roi_mask \\
      --annot-lh lh.HCP-MMP1.annot --annot-rh rh.HCP-MMP1.annot \\
      --regions L_V1_ROI R_V1_ROI --out v1_mask.p
"""

import argparse
import pickle

from multimodal_decoding_tpu_torch.io.annot import read_annot


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annot-lh", type=str, required=True)
    parser.add_argument("--annot-rh", type=str, required=True)
    parser.add_argument("--regions", type=str, nargs="+", required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--list-regions", action="store_true")
    args = parser.parse_args(argv)

    annots = {"left": read_annot(args.annot_lh), "right": read_annot(args.annot_rh)}
    if args.list_regions:
        for hemi, annot in annots.items():
            print(f"{hemi}: {annot.names}")
        return

    mask = {}
    for hemi, annot in annots.items():
        wanted = [r for r in args.regions if r in annot.names]
        mask[hemi] = annot.mask_for(wanted) if wanted else annot.labels * 0
        print(f"{hemi}: {int(mask[hemi].sum())} vertices in {wanted}")
    with open(args.out, "wb") as f:
        pickle.dump(mask, f)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
