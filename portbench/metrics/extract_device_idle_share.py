"""Share of the extraction window in which no operation ran on the device:
100 x (1 - union of the device's operation intervals / window), from the
traced run's profiler trace."""


def read(ctx):
    if ctx.trace is None or not ctx.record.get("stimuli"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
