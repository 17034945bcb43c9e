"""GB/s of the streamed upload's host-to-device copies: the bytes of the
float32 rows ``streamed_x_all_device`` sent in the window's calls over the
device time of the window's host-to-device copies, from the traced run's
profiler trace (the stand-in runner sends nothing, so every such copy in the
window is the upload's).  None where the trace shows no such copy or no call
streamed."""

COPIES = "Memcpy HtoD"


def read(ctx):
    if ctx.trace is None:
        return None
    sent = sum(ctx.record.get("upload_bytes") or ())
    seconds = sum(s for name, s in ctx.trace["device_ops"] if name.startswith(COPIES))
    return sent / 1e9 / seconds if sent and seconds else None
