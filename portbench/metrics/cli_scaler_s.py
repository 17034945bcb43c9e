"""Host seconds a call in the program's ``streamed_scaler_fit``: the train
statistics' two float64 passes over the train cache, timed through the
look-up ``decoding/searchlight.run`` calls it by (None where no call made it)."""


def read(ctx):
    made = [s for s in ctx.record.get("scaler_s") or () if s is not None]
    return sum(made) / len(made) if made else None
