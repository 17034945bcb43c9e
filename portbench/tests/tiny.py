"""Tiny versions of the benchmark's cells, for the CPU tests.

Each tiny cell keeps its configuration's and traffic's keys and their
meaning and shrinks only the sizes, so a run exercises every path of the
driver, the program and the reference in a second or two.
"""

from __future__ import annotations

from portbench.harness import bench

TINY_CONFIG = {
    "searchlight": dict(icosphere_subdivisions=2, n_neighbors=12, n_train=60, n_test=20,
                        latent_dim=8, block_size=16, signal_log10=[-1.5, 0.0]),
    "whole_brain": dict(n_features=3000, n_train=100, n_test=20, latent_dim=8, noise=2.0,
                        block_cols=512, mode_rows={"agnostic": [0, 100], "captions": [0, 50],
                                                   "images": [50, 100]}),
}
TINY_TRAFFIC = {
    "searchlight": dict(n_permutations=5, blocks_per_call=2, sample=1000, reference_chunk=8),
    "whole_brain": dict(sample=3),
}
CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def tiny_cell(name: str):
    cell = bench.cell(name)
    kind = cell.traffic["driver"]
    return (dict(cell.config, **TINY_CONFIG[kind]), dict(cell.traffic, **TINY_TRAFFIC[kind]),
            kind)


def run_tiny(name: str, seed: int = 20261017, seconds: float = 0.3):
    """Set-up, window and check of a tiny cell on the CPU: (driver, record, numbers)."""
    config, traffic, kind = tiny_cell(name)
    drv = bench.module("drivers", kind).Driver(config, traffic, seed, "cpu")
    drv.setup()
    record = drv.window(seconds)
    drv.release()
    return drv, record, drv.check()
