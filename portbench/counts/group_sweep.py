"""Least work of one chunk of the group null's t-map sweep: for each of the
composite's ``members``, ``c`` permutations each gather one within-subject
map of each of the ``s`` subjects, and a t-map over the subjects is taken
at each of ``v`` vertices; the members' minimum is written once.  Float32.

* ``gather``: each distinct (subject, within-subject map) row the chunk
  gathers, read once a member: ``members * distinct * v`` floats (the
  deployment's lexicographic permutations share most rows within a chunk);
* ``t_maps``: per member, permutation and vertex, ``s`` subtractions of the
  chance level, ``s`` additions for the mean, ``3 s`` for the centred
  squares and their sum, and 4 for the variance, the standard error and
  the ratio: ``5 s + 4`` operations, and 2 for the minimum and its NaN rule;
* ``t_min_out``: the [c, v] minimum written once.
"""

from __future__ import annotations


def terms(members: int, s: int, c: int, distinct: int, v: int) -> dict:
    """{name: (flops, bytes)}; ``distinct`` counts the chunk's distinct
    (subject, within-subject map) pairs."""
    return {
        "gather": (0, members * distinct * v * 4),
        "t_maps": (members * c * v * (5 * s + 6), 0),
        "t_min_out": (0, c * v * 4),
    }
