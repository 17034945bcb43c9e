"""Host milliseconds of TFCE a map: the seconds the window's calls spent in
``ops/tfce.tfce_map`` (the native engine, its threads over a chunk's maps),
on the host's clock, over the maps it was given."""


def read(ctx):
    maps = ctx.record.get("tfce_maps")
    return 1e3 * ctx.record["tfce_s"] / maps if maps else None
