"""Searchlight vertices a second: every vertex the window's calls completed
over the whole window, on the host's clock (each call ends in a device
synchronisation).  A hemisphere of fsaverage7 takes 163,842 / this."""


def read(ctx):
    vertices = ctx.record.get("vertices")
    return vertices / ctx.record["window_s"] if vertices else None
