"""Device milliseconds a searchlight block spends in its ridge solve: the
stream time of the program's ``mdt.engine.solve`` spans (``ops/solvers.
spd_solve``: the strict refit at the selected alphas, or the fixed-alpha
solve) over the window's blocks."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    return None if s is None else stages.per_block_ms(s, stages.stream_s(s, "mdt.engine.solve"))
