"""Share of the towers' roofline: the least time of every batch the window
ran (the configuration's counts module, ``flop_counts``: the larger of its
operations at float32's peak and its bytes at the memory bandwidth,
``counts/peaks.py``) over the time the device's kernels ran inside the
spans ``portbench.extract_forward`` that wrap ``imagebind_embed``, in %."""

FORWARD_SPAN = "portbench.extract_forward"


def read(ctx):
    span = (ctx.trace or {}).get("spans", {}).get(FORWARD_SPAN)
    batches = ctx.record.get("batch_tokens")
    if not span or not span["kernel_s"] or not batches:
        return None
    counts, peaks = ctx.counts(ctx.config["flop_counts"]), ctx.counts("peaks")
    least = sum(peaks.least_seconds(counts.terms(ctx.config, tokens))[0] for tokens in batches)
    return 100.0 * least / span["kernel_s"]
