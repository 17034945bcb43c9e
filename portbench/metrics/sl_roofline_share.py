"""Share of the searchlight blocks' roofline: the least time of every block
the traced window ran (``counts/sl_block.py`` at the float32 peak, the
larger of operations and bytes) over the device's busy time in it, in %.

Each vertex is counted at its live width: the adjacency's width, or where
the driver keeps a mask of live columns (``mask`` [V, Kmax], a padded
adjacency) its own count, its padded columns credited with nothing; the
gather reads the block's distinct live columns.  The padding a block
computes shows as a lower share."""

import numpy as np


def read(ctx):
    if ctx.trace is None or not ctx.record.get("blocks") or not ctx.trace["busy_s"]:
        return None
    cfg, tr, drv = ctx.config, ctx.traffic, ctx.driver
    sl_block, peaks = ctx.counts("sl_block"), ctx.counts("peaks")
    mask = getattr(drv, "mask", None)
    sizes = cfg["n_train"], cfg["n_test"], cfg["n_imagery"]
    rest = cfg["latent_dim"], cfg["n_splits"], len(tr.get("alphas", ()))
    B, least = ctx.record["block_size"], 0.0
    for b in ctx.record["block_ids"]:
        nbr = drv.adjacency[b * B:(b + 1) * B]
        live = np.ones(nbr.shape, dtype=bool) if mask is None else mask[b * B:(b + 1) * B]
        widths, n = np.unique(live.sum(axis=1), return_counts=True)
        flops = sum(f for k, c in zip(widths, n)
                    for f, _ in sl_block.terms(*sizes, int(k), *rest, int(c), 0).values())
        nbytes = sum(nb for _, nb in sl_block.terms(
            *sizes, 0, *rest, 0, int(np.unique(nbr[live]).size)).values())
        least += peaks.least_seconds({"block": (flops, nbytes)})[0]
    return 100.0 * least / ctx.trace["busy_s"]
