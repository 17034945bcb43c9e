"""Peak device memory of the searchlight window, GiB: the allocator's
``max_memory_allocated`` after a reset at the window's start (the resident
betas included)."""


def read(ctx):
    if not ctx.record.get("vertices") or "peak_window_bytes" not in ctx.record:
        return None
    return ctx.record["peak_window_bytes"] / 2 ** 30
