"""Host seconds a call in the program's ``streamed_x_all_device``: every
split's cache read again, its NaN columns dropped, standardised and copied to
the card through pinned buffers, timed through the look-up
``decoding/searchlight.run`` calls it by (None where no call made it)."""


def read(ctx):
    made = [s for s in ctx.record.get("upload_s") or () if s is not None]
    return sum(made) / len(made) if made else None
