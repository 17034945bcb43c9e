"""Planting helpers that any driver's ``FAULTS`` may use: each takes a
program function and returns it with a fault planted, for the CPU tests
only.  A helper that fits one driver alone lives in that driver's module."""

from __future__ import annotations


def stale(fn):
    """A step that returns its state unchanged: every call after the first
    hands back the first call's answer."""
    first = []

    def step(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return step
