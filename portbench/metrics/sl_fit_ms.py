"""Device milliseconds a searchlight block spends in its fit's products: the
stream time of the program's ``mdt.engine.fit`` spans (``decoding/
searchlight_engine.fit_block``: the patch gram and X^T Y) over the window's
blocks."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    return None if s is None else stages.per_block_ms(s, stages.stream_s(s, "mdt.engine.fit"))
