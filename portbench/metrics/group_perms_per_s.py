"""Group permutations a second: every group permutation the window's calls
completed on both hemispheres (its largest TFCE value returned), over the
whole window, on the host's clock (each call ends in the host's TFCE of its
last chunk).  A user's 10,000-permutation null takes 10,000 / this seconds."""


def read(ctx):
    perms = ctx.record.get("perms")
    return perms / ctx.record["window_s"] if perms else None
