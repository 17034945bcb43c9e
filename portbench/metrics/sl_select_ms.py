"""Device milliseconds a searchlight block spends selecting its alphas: the
stream time of the program's ``mdt.engine.select`` spans
(``decoding/searchlight_engine.fit_block_cv`` from the full gram to
``best_alpha``: fold grams, per-alpha solves, fold scoring) over the
window's blocks."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    return None if s is None else stages.per_block_ms(s, stages.stream_s(s, "mdt.engine.select"))
