"""Device milliseconds a searchlight block spends outside its engine step:
the stream time of the runner's ``mdt.runner.block`` spans less that of the
``mdt.engine.step`` spans inside them (the block's uploads, the flushes of
its outputs to the host, checkpoints), over the window's blocks."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    if s is None:
        return None
    block, step = stages.stream_s(s, stages.BLOCK), stages.stream_s(s, "mdt.engine.step")
    return None if block is None or step is None else stages.per_block_ms(s, block - step)
