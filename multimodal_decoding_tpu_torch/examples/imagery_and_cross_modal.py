"""Example: imagery + zero-shot cross-modal analytics from stored results.

The port's counterpart of ``examples/imagery_and_cross_modal.py``, the
script form of the reference's imagery_decoding / zero_shot_cross_modal
notebooks (notebooks/*.ipynb, aggregation utilities in notebook_utils.py):
glob whole-brain results pickles into the long-form DataFrame, summarise the
mental-imagery and cross-decoding metric families per model, and demonstrate
the offline-recompute contract (results store predictions + latents, so
metrics can be recomputed without refitting —
ridge_regression_decoding.py:137-157).  ``--recompute`` scores on
``--device`` (default ``cuda``); the frame needs pandas.

Run after decode_whole_brain (or the full_pipeline example):
  python -m multimodal_decoding_tpu_torch.examples.imagery_and_cross_modal \\
      --results-dir ~/results/ridge_decoding [--device cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", type=str, required=True)
    ap.add_argument("--recompute", action="store_true", default=False,
                    help="recompute metrics from the stored predictions "
                         "instead of trusting the stored scores")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the recomputed metrics")
    args = ap.parse_args(argv)

    from multimodal_decoding_tpu_torch.device import resolve_device
    from multimodal_decoding_tpu_torch.ops import metrics as M
    from multimodal_decoding_tpu_torch.viz import reporting as VR

    device = resolve_device(args.device)
    df = VR.load_results_frame(args.results_dir, recompute_metrics=args.recompute,
                               device=device)
    if df.empty:
        raise SystemExit(f"no results.p under {args.results_dir}")
    print(f"{df.subject.nunique()} subjects x {df.model.nunique()} models, "
          f"{len(df)} metric rows\n")

    imagery = [m for m in (M.ACC_IMAGERY, M.ACC_IMAGERY_WHOLE_TEST)
               if m in set(df.metric)]
    cross = [m for m in (M.ACC_CROSS_CAPTIONS_TO_IMAGES, M.ACC_CROSS_IMAGES_TO_CAPTIONS)
             if m in set(df.metric)]

    for family, metrics in (("mental imagery", imagery),
                            ("zero-shot cross-modal", cross)):
        if not metrics:
            print(f"({family}: metrics not present in these results)")
            continue
        print(f"== {family} ==")
        for metric in metrics:
            s = VR.summarize(df, metric, by=("model",))
            for model, row in s.iterrows():
                print(f"  {metric:45s} {model:12s} "
                      f"mean {row['mean']:.3f}  (n={int(row['count'])})")
        print()


if __name__ == "__main__":
    main()
