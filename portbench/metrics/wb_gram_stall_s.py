"""Seconds a whole-brain gram's stream waits on the host: the stream time of
the program's ``mdt.gram.build`` spans (``GramCache``'s build) less that of
the column blocks' transfers (``mdt.gram.h2d``) and products
(``mdt.gram.products``) inside them, over the window's grams: what the host
staging into the pinned buffers leaves unhidden."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    build = s and s["spans"].get("mdt.gram.build")
    if not build or build["stream_s"] is None:
        return None
    inside = sum(stages.stream_s(s, n) or 0.0 for n in ("mdt.gram.h2d", "mdt.gram.products"))
    return (build["stream_s"] - inside) / build["count"]
