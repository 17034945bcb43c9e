"""Stimuli a second: every stimulus whose caption and image embeddings the
window's calls of the extraction loop completed (each call ends with its
pickle written), over the whole window, on the host's clock.  A user's
extraction of N stimuli takes N / this seconds."""


def read(ctx):
    stimuli = ctx.record.get("stimuli")
    return stimuli / ctx.record["window_s"] if stimuli else None
