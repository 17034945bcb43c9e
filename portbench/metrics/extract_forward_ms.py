"""Device milliseconds of both towers a batch: the union of the device's
kernel intervals (copies and sets left out) inside the spans
``portbench.extract_forward`` that wrap ``imagebind_embed`` (each ending in
a device synchronisation), over the spans."""

FORWARD_SPAN = "portbench.extract_forward"


def read(ctx):
    span = (ctx.trace or {}).get("spans", {}).get(FORWARD_SPAN)
    if not span or not span["kernel_s"] or not span["count"]:
        return None
    return 1e3 * span["kernel_s"] / span["count"]
