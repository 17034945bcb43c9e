"""Least work of the whole-brain kernels of one dataset: ``K = X X^T`` over
the n train rows and ``Xq X^T`` over the nq test and imagery rows, V
features each, float32.

* ``gram``: K once per distinct entry (it is symmetric), n (n + 1) / 2 sums
  of V products;
* ``query``: nq x n sums of V products;
* ``betas_in``: every beta read once, (n + nq) V floats;
* ``kernels_out``: K's distinct entries and the query kernels written once.
"""

from __future__ import annotations


def terms(n: int, nq: int, v: int) -> dict:
    """{name: (flops, bytes)}."""
    return {
        "gram": (n * (n + 1) * v, 0),
        "query": (2 * nq * n * v, 0),
        "betas_in": (0, (n + nq) * v * 4),
        "kernels_out": (0, (n * (n + 1) // 2 + nq * n) * 4),
    }
