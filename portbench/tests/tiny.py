"""Tiny versions of the benchmark's cells, for the CPU tests.

Each tiny cell keeps its configuration's and traffic's keys and their
meaning and shrinks only the sizes, which its driver module gives
(``TINY_CONFIG``, ``TINY_TRAFFIC``), so a run exercises every path of the
driver, the program and the reference in a second or two.
"""

from __future__ import annotations

from portbench.harness import bench

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def tiny_cell(name: str):
    """``(configuration, traffic, driver name)`` of the cell at its driver's
    ``TINY_CONFIG`` and ``TINY_TRAFFIC`` sizes."""
    cell = bench.cell(name)
    kind = cell.traffic["driver"]
    drv = bench.module("drivers", kind)
    return dict(cell.config, **drv.TINY_CONFIG), dict(cell.traffic, **drv.TINY_TRAFFIC), kind


def run_tiny(name: str, seed: int = 20261017, seconds: float = 0.3, windows: int = 1):
    """Set-up, window and check of a tiny cell on the CPU: (driver, record, numbers).
    ``windows`` > 1 runs that many windows in turn, so the check sees at least
    as many calls of the program whatever the CPU's load (the record is the
    last window's)."""
    config, traffic, kind = tiny_cell(name)
    drv = bench.module("drivers", kind).Driver(config, traffic, seed, "cpu")
    drv.setup()
    for _ in range(windows):
        record = drv.window(seconds)
    drv.release()
    return drv, record, drv.check()
