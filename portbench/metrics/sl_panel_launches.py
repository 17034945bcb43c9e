"""Launches of the panel kernel (B1, ``csrc/chol_inv_panel.cu``) a
searchlight block: the program's counter ``ops/hopper_solvers.launches``
over the window, which the driver records at the window's start and end,
over the window's blocks.  The CPU path counts none, and then there is
nothing to read."""


def read(ctx):
    launches = ctx.record.get("panel_launches")
    if not launches or not ctx.record.get("blocks"):
        return None
    return launches / ctx.record["blocks"]
