"""CLI: DNN feature extraction on one GPU.

One entry point replacing the reference's per-model scripts under
feature_extraction/ (extract_clip_features.py etc.):

  python -m multimodal_decoding_tpu_torch.cli.extract_features --model imagebind
  python -m multimodal_decoding_tpu_torch.cli.extract_features --model gabor
  python -m multimodal_decoding_tpu_torch.cli.extract_features --model imagebind --random-init

Same flags and output pickle as the JAX package's CLI, plus ``--device``
(default ``cuda``; no CPU fallback).  Model registry (HF torch classes, the
in-framework ImageBind, reference batch sizes):
multimodal_decoding_tpu_torch/extraction/extractors.py.
"""

import argparse

from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.extraction.harness import StimuliDataset, run_extraction


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--random-init", action="store_true", default=False,
                        help="random-weight control variant "
                             "(the reference's random-imagebind pattern)")
    parser.add_argument("--stim-info-path", type=str, default=None)
    parser.add_argument("--coco-root", type=str, default=None)
    parser.add_argument("--out-path", type=str, default=None)
    parser.add_argument("--region-features", type=str, default=None,
                        help="visualbert only: pickle of cached Mask-RCNN "
                             "region features {stim_id: [n_boxes, 1024]} "
                             "(stage 1, extraction/visualbert.py)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="device to run on (default cuda; no CPU fallback)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)  # no GPU and no --device cpu: stop before any work
    dataset = StimuliDataset.from_csv(args.stim_info_path, args.coco_root)

    if args.model == "gabor":
        from multimodal_decoding_tpu_torch.extraction.gabor import make_gabor_extractor

        extract_fn = make_gabor_extractor(device=device)
        batch_size = args.batch_size or 100
        model_name = "gabor"
    elif args.model == "moten":
        from multimodal_decoding_tpu_torch.extraction.motion_energy import (
            make_motion_energy_extractor,
        )

        extract_fn = make_motion_energy_extractor(device=device)
        batch_size = args.batch_size or 100
        model_name = "moten"
    elif args.model == "visualbert":
        import pickle

        import transformers

        from multimodal_decoding_tpu_torch.extraction.extractors import REGISTRY
        from multimodal_decoding_tpu_torch.extraction.visualbert import (
            make_visualbert_extractor,
        )

        if not args.region_features:
            raise SystemExit(
                "visualbert is two-stage: run the Mask-RCNN stage on a host "
                "with a detector (extraction/visualbert.extract_region_features) "
                "and pass the cache via --region-features"
            )
        spec = REGISTRY["visualbert"]
        model = transformers.VisualBertModel.from_pretrained(spec.hf_name).to(device)
        tokenizer = transformers.AutoTokenizer.from_pretrained("bert-base-uncased")
        with open(args.region_features, "rb") as f:
            regions = pickle.load(f)
        extract_fn = make_visualbert_extractor(model, tokenizer, regions)
        batch_size = args.batch_size or spec.batch_size
        model_name = "visualbert"
    else:
        from multimodal_decoding_tpu_torch.extraction.extractors import REGISTRY, build_extractor

        if args.model not in REGISTRY:
            raise SystemExit(
                f"Unknown model '{args.model}'. Registered: {sorted(REGISTRY)} (+ 'gabor', 'moten'). "
                "For models without local weights, use "
                "extraction.harness.import_external_features."
            )
        try:
            _, _, extract_fn = build_extractor(args.model, pretrained=not args.random_init,
                                               device=device)
        except ValueError as e:  # external-import / two-stage models
            raise SystemExit(str(e)) from None
        batch_size = args.batch_size or REGISTRY[args.model].batch_size
        model_name = f"random-{args.model}" if args.random_init else args.model
        note = getattr(REGISTRY[args.model], "note", None)
        if note:
            # surface checkpoint-provenance caveats (e.g. BLIP-2 rebuilt on
            # the transformers ITM checkpoint, not the LAVIS pretrain) at
            # extraction time, not only in the registry source
            print(f"[{args.model}] note: {note}", flush=True)

    run_extraction(extract_fn, model_name, dataset, batch_size, args.out_path)


if __name__ == "__main__":
    main()
