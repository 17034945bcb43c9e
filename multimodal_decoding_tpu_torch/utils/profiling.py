"""Tracing & profiling helpers.

The reference instruments its two hot fits with bare ``time.time()`` brackets
(ridge_regression_decoding.py:122-125, searchlight.py:250-257).  Here the
same boundaries get structured timers, whose stage boundaries wait for the
GPU's queued work, and optional ``torch.profiler`` traces.

Spans and counters.  The program marks its stages with ``span(name)`` and
its transferred bytes with ``count(name, n)``; every name starts with
``mdt.``.  Both are on exactly while a ``torch.profiler`` profile records
(``device_trace``, or any other ``profile``), and cost one check otherwise.
A span that is on opens a ``record_function`` (so the stage shows in the
profiler's trace, on the clock of the device's kernels and copies), takes
the host's clock at entry and exit, and on a CUDA device records a timing
event on the stream current at its entry, at entry and at exit: the time
between the two is the stream time of the work the span queued, including
any idle while the stream waited for the host.  ``summary()`` returns the
totals per name; ``reset()`` clears them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.2f}s ({100 * v / max(total, 1e-9):.0f}%)" for k, v in self.stages.items()]
        return " | ".join(lines) + f" | total {total:.2f}s"


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler trace (CPU, and CUDA where available) around a block,
    written as a Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir``
    (no-op when log_dir is None).  Yields the profiler (``None`` when off).
    The program's ``mdt.*`` spans are on inside it and show in the trace;
    ``summary()`` after it gives their totals."""
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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------


class _Totals:
    __slots__ = ("count", "host_ns", "self_ns", "stream_ms")

    def __init__(self):
        self.count = self.host_ns = self.self_ns = 0
        self.stream_ms = None  # None until a span of this name records events


class _Span:
    """One open span: its record_function, host clock and stream events."""

    __slots__ = ("record", "name", "rf", "t0", "child_ns", "stream", "start")

    def __init__(self, record: "SpanRecord", name: str):
        self.record, self.name = record, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.record._stack().append(self)
        self.child_ns, self.start = 0, None
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.start = self.record._event(self.stream)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        try:
            events = None
            if self.start is not None:
                end = self.record._event(self.stream)
                end.record(self.stream)
                events = (self.start, end, self.stream.device.index)
            stack = self.record._stack()
            stack.pop()
            if stack:
                stack[-1].child_ns += host_ns
            self.record._add(self.name, host_ns, host_ns - self.child_ns, events)
        finally:
            self.rf.__exit__(*exc)
        return False


class SpanRecord:
    """Totals per span name and per counter, kept while a profile records.

    Parents are tracked by a stack per thread, so a span's self time leaves
    out its children's.  A span's two CUDA events are folded into its name's
    total once the end event has completed (at a later span's exit, or at
    ``summary()``) and go back to a pool, so the record stays bounded over
    any number of spans.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool: dict = {}  # device index -> idle timing events
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: dict[str, _Totals] = {}
            self._counters: dict[str, int | float] = {}
            self._pending: deque = deque()  # (totals, (start, end, device index))

    def span(self, name: str):
        if not torch.autograd._profiler_enabled():
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n) -> None:
        if torch.autograd._profiler_enabled():
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def summary(self) -> dict:
        """``{"spans": {name: {"count", "host_s", "self_host_s", "stream_s"}},
        "counters": {name: total}}``; ``stream_s`` is None where no span of
        the name ran on a CUDA device.  Waits for the spans' end events."""
        with self._lock:
            self._fold(wait=True)
            spans = {name: {"count": t.count, "host_s": t.host_ns * 1e-9,
                            "self_host_s": t.self_ns * 1e-9,
                            "stream_s": None if t.stream_ms is None else t.stream_ms * 1e-3}
                     for name, t in self._spans.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self, stream):
        with self._lock:
            pool = self._pool.setdefault(stream.device.index, [])
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _add(self, name: str, host_ns: int, self_ns: int, events) -> None:
        with self._lock:
            t = self._spans.get(name)
            if t is None:
                t = self._spans[name] = _Totals()
            t.count += 1
            t.host_ns += host_ns
            t.self_ns += self_ns
            if events is not None:
                if t.stream_ms is None:
                    t.stream_ms = 0.0
                self._pending.append((t, events))
            self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Add the elapsed time of completed spans, oldest first (the lock held)."""
        while self._pending:
            t, (start, end, device) = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            t.stream_ms += start.elapsed_time(end)
            self._pool.setdefault(device, []).extend((start, end))


_OFF = contextlib.nullcontext()
_RECORD = SpanRecord()


def span(name: str):
    """A span of the program's stage ``name`` (``mdt.<layer>.<stage>``): the
    shared no-op context unless a ``torch.profiler`` profile records."""
    return _RECORD.span(name)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``, only while a profile records."""
    _RECORD.count(name, n)


def summary() -> dict:
    """The spans' and counters' totals since the last ``reset()``."""
    return _RECORD.summary()


def reset() -> None:
    _RECORD.reset()
