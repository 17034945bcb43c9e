"""GB/s of a whole-brain gram's host-to-device transfers: the bytes the
program counts in ``mdt.gram.h2d_bytes`` over the stream time of its
``mdt.gram.h2d`` spans (each column block's uploads from the pinned
buffers)."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    if s is None:
        return None
    sent, seconds = s["counters"].get("mdt.gram.h2d_bytes"), stages.stream_s(s, "mdt.gram.h2d")
    return None if not sent or not seconds else sent / 1e9 / seconds
