"""Seconds of a whole-brain alpha CV: the mean of ``decode_single``'s
``timings["cv_s"]`` (``ops/ridge.ridge_cv_dual``'s selection, ended by a
device synchronisation) over the window's decodes."""


def read(ctx):
    cv = ctx.record.get("cv_seconds")
    return sum(cv) / len(cv) if cv else None
