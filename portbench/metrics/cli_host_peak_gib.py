"""GiB by which the process's resident memory rose during a call of ``run()``
at the most: VmRSS sampled every ``rss_interval_s`` through each call, less
its value at the call's start, the largest over the calls.  The streamed path
keeps the betas to O(chunk) host memory; the eager path holds several copies
of the train betas."""


def read(ctx):
    rises = [r for r in ctx.record.get("host_rise_bytes") or () if r is not None]
    return max(rises) / 2 ** 30 if rises else None
