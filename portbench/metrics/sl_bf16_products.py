"""bf16 GEMMs a searchlight block: the program's counter
``mdt.precision.bf16`` (``ops/precision``: one a cuBLAS bf16 product on the
card) over the window, over the window's blocks.  The CPU path and the
float32 path count none, and then there is nothing to read."""

from portbench.harness import stages

COUNTER = "mdt.precision.bf16"


def read(ctx):
    s = stages.program_summary()
    blocks = ctx.record.get("blocks")
    if s is None or not blocks or COUNTER not in s["counters"]:
        return None
    return s["counters"][COUNTER] / blocks
