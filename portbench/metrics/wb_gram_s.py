"""Seconds of a whole-brain gram: the mean of ``GramCache.gram_seconds``
(host staging, transfers and products, ended by a device synchronisation)
over the window's decodes that built one."""


def read(ctx):
    grams = ctx.record.get("gram_seconds")
    return sum(grams) / len(grams) if grams else None
