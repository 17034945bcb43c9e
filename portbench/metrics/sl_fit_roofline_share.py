"""Share of the searchlight fit's roofline under the 16-bit contract: the
least time of the window's patch grams and X^T Y (``counts/sl_block.py``'s
``gram`` and ``cross`` terms, every vertex the window completed, at the
adjacency's width) at the bf16 dense peak (``counts/bf16_peak.py``) over
the stream time of the program's ``mdt.engine.fit`` spans, in %.  The
stream time includes any wait of the stream inside the spans, so the share
reads low rather than high."""

from portbench.harness import stages


def read(ctx):
    s = stages.program_summary()
    fit_s = None if s is None else stages.stream_s(s, "mdt.engine.fit")
    vertices = ctx.record.get("vertices")
    if not fit_s or not vertices:
        return None
    cfg = ctx.config
    t = ctx.counts("sl_block").terms(cfg["n_train"], cfg["n_test"], cfg["n_imagery"],
                                     ctx.driver.adjacency.shape[1], cfg["latent_dim"],
                                     cfg["n_splits"], 0, vertices, 0)
    flops = t["gram"][0] + t["cross"][0]
    return 100.0 * flops / ctx.counts("bf16_peak").BF16_FLOP_PER_S / fit_s
