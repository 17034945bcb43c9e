"""Share of the group null's t-map sweep's roofline: the least time of every
chunk the traced window swept (``counts/group_sweep.py``, the larger of its
operations at the float32 peak and its bytes at the memory bandwidth) over
the time the device's kernels ran inside the calls' spans (as
``group_sweep_ms`` reads it), in %."""

CALL_SPAN = "portbench.group_null"


def read(ctx):
    span = (ctx.trace or {}).get("spans", {}).get(CALL_SPAN)
    chunks = ctx.record.get("sweep_chunks")
    if not span or not span["kernel_s"] or not chunks:
        return None
    cfg = ctx.config
    group_sweep, peaks = ctx.counts("group_sweep"), ctx.counts("peaks")
    least = sum(peaks.least_seconds(group_sweep.terms(len(cfg["members"]), cfg["n_subjects"], c,
                                                      distinct, cfg["n_vertices"]))[0]
                for c, distinct in chunks)
    return 100.0 * least / span["kernel_s"]
