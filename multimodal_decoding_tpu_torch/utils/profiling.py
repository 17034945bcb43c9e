"""Tracing & profiling helpers.

The reference instruments its two hot fits with bare ``time.time()`` brackets
(ridge_regression_decoding.py:122-125, searchlight.py:250-257).  Here the
same boundaries get structured timers, whose stage boundaries wait for the
GPU's queued work, and optional ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    """Wait for the GPU's queued work, where this process uses CUDA: a
    stage's seconds then include the device work it queued."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Collects named wall-clock stages; printable summary."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.time()
        try:
            yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + (time.time() - t0)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.2f}s ({100 * v / max(total, 1e-9):.0f}%)" for k, v in self.stages.items()]
        return " | ".join(lines) + f" | total {total:.2f}s"


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler trace (CPU, and CUDA where available) around a block,
    written as a Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir``
    (no-op when log_dir is None).  Yields the profiler (``None`` when off)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
