"""Staged uploads a searchlight block: the program's counter
``mdt.runner.staged_upload`` (``parallel/searchlight_runner``: one a block
whose indices, mask and derangements reached the card by non-blocking
copies from the runner's ring of pinned host buffers) over the window, over
the window's blocks.  The CPU path counts none, and a program without the
counter records nothing under its name: then there is nothing to read."""

from portbench.harness import stages

COUNTER = "mdt.runner.staged_upload"


def read(ctx):
    s = stages.program_summary()
    blocks = ctx.record.get("blocks")
    if s is None or not blocks or COUNTER not in s["counters"]:
        return None
    return s["counters"][COUNTER] / blocks
