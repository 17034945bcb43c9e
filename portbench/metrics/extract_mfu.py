"""The whole extraction step's share of the chip's peak: the model's
operations for every stimulus the window completed (each batch's terms
from the counts module the configuration names under ``flop_counts``), at
float32's peak outside the tensor cores (``counts/peaks.py``; the port runs
float32 with TF32 off) over the window's seconds, in %."""


def read(ctx):
    batches = ctx.record.get("batch_tokens")
    if not batches:
        return None
    counts = ctx.counts(ctx.config["flop_counts"])
    flops = sum(f for tokens in batches for f, _ in counts.terms(ctx.config, tokens).values())
    return 100.0 * flops / ctx.counts("peaks").FP32_FLOP_PER_S / ctx.record["window_s"]
