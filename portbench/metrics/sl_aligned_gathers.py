"""Aligned patch gathers a searchlight block: the program's counter
``mdt.engine.aligned_gather`` (``decoding/searchlight_engine.gather_patches``:
one a gather of 16-bit patches into rows padded to 16 bytes) over the window,
over the window's blocks.  The float32 path counts none, and a program
without the counter records nothing under its name: then there is nothing to
read."""

from portbench.harness import stages

COUNTER = "mdt.engine.aligned_gather"


def read(ctx):
    s = stages.program_summary()
    blocks = ctx.record.get("blocks")
    if s is None or not blocks or COUNTER not in s["counters"]:
        return None
    return s["counters"][COUNTER] / blocks
