"""Host seconds a call in ``io/artifacts.save_pickle`` and
``save_null_scores_npz``: the results pickle (with the adjacency and the
distances) and the compressed null maps (None where no call wrote them)."""


def read(ctx):
    made = [s for s in ctx.record.get("write_s") or () if s is not None]
    return sum(made) / len(made) if made else None
