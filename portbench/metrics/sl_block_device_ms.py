"""Device milliseconds a searchlight block: the union of the device's
operation intervals over the traced window, over the blocks it ran."""


def read(ctx):
    if ctx.trace is None or not ctx.record.get("blocks"):
        return None
    return 1e3 * ctx.trace["busy_s"] / ctx.record["blocks"]
