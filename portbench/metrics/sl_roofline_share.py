"""Share of the searchlight blocks' roofline: the least time of every block
the traced window ran (``counts/sl_block.py`` at the float32 peak, the
larger of operations and bytes) over the device's busy time in it, in %."""

import numpy as np


def read(ctx):
    if ctx.trace is None or not ctx.record.get("blocks") or not ctx.trace["busy_s"]:
        return None
    cfg, tr, drv = ctx.config, ctx.traffic, ctx.driver
    sl_block, peaks = ctx.counts("sl_block"), ctx.counts("peaks")
    B, least = ctx.record["block_size"], 0.0
    for b in ctx.record["block_ids"]:
        nbr = drv.adjacency[b * B:(b + 1) * B]
        least += peaks.least_seconds(sl_block.terms(
            cfg["n_train"], cfg["n_test"], cfg["n_imagery"], cfg["n_neighbors"],
            cfg["latent_dim"], cfg["n_splits"], len(tr.get("alphas", ())), len(nbr),
            int(np.unique(nbr).size)))[0]
    return 100.0 * least / ctx.trace["busy_s"]
