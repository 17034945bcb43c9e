"""Share of the whole-brain grams' roofline: the least time of every gram the
traced window built (``counts/wb_gram.py`` at the float32 peak, the larger of
operations and bytes) over the time the device's kernels ran inside the
spans ``portbench.gram`` that build them (the union of the kernels'
intervals; the host's staging and the copies to the device left out), in %."""

GRAM_SPAN = "portbench.gram"


def read(ctx):
    span = (ctx.trace or {}).get("spans", {}).get(GRAM_SPAN)
    if not span or not span["kernel_s"] or span["count"] != len(ctx.record["gram_rows"]):
        return None
    cfg = ctx.config
    wb_gram, peaks = ctx.counts("wb_gram"), ctx.counts("peaks")
    least = sum(peaks.least_seconds(wb_gram.terms(n, cfg["n_test"] + cfg["n_imagery"],
                                                  cfg["n_features"]))[0]
                for n in ctx.record["gram_rows"])
    return 100.0 * least / span["kernel_s"]
