"""Whole-brain seconds a decode: the whole window over the decodes it
completed, on the host's clock (each decode ends in its scores on the host)."""


def read(ctx):
    decodes = ctx.record.get("decodes")
    return ctx.record["window_s"] / decodes if decodes else None
