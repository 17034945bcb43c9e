"""Host seconds a call in the program's ``build_adjacency``: here the load of
the 750-NN adjacency from the adjacency cache, timed through the look-up
``decoding/searchlight.run`` calls it by (None where no call made it)."""


def read(ctx):
    made = [s for s in ctx.record.get("adjacency_s") or () if s is not None]
    return sum(made) / len(made) if made else None
