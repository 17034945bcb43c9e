"""Seconds of the searchlight CLI's ``run()`` for one hemisphere outside the
searchlight's blocks: the whole window over the calls it completed, on the
host's clock (each call reads the betas caches, streams ``X_all`` to the card,
loads the latents and the cached adjacency, and writes the results files)."""


def read(ctx):
    calls = ctx.record.get("calls")
    return ctx.record["window_s"] / calls if calls and "call_seconds" in ctx.record else None
