"""Device milliseconds of the group null's t-map sweep a chunk: the union of
the device's kernel intervals (copies and sets left out) inside the spans
``portbench.group_null`` that wrap the window's calls, over the chunks the
calls swept on both hemispheres.  The calls' only kernels are the sweep's
(``ops/stats.null_min_t_maps``: gather, t-maps, members' minimum); TFCE runs
on the host."""

CALL_SPAN = "portbench.group_null"


def read(ctx):
    span = (ctx.trace or {}).get("spans", {}).get(CALL_SPAN)
    chunks = ctx.record.get("chunks")
    if not span or not span["kernel_s"] or not chunks:
        return None
    return 1e3 * span["kernel_s"] / chunks
