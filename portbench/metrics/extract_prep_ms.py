"""Host milliseconds of a batch's images: the window's PIL loads
(``StimuliDataset.load_image``: open, decode, RGB) and
``imagebind.preprocess_images`` (bicubic resize, crop, normalisation), on
the host's clock, over the batches."""


def read(ctx):
    batches = ctx.record.get("batches")
    if not batches:
        return None
    return 1e3 * (ctx.record["load_s"] + ctx.record["preprocess_s"]) / batches
