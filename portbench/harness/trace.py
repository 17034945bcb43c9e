"""The traced run's reading of the device: busy time, top device operations,
idle gaps and the kernels' time inside each of the harness's spans, from
``torch.profiler`` over the measured window.

The device is busy where any of its operations (kernel, copy, set) runs:
the union of their intervals, clipped to the window, which is the span
``portbench.window`` the harness records around it on the host.  An idle
gap is named by what the host was doing at its middle: the innermost
operation or span open then on the thread that drives the window.  A span's
kernel time is the union of the kernels' intervals (copies and sets left
out) that fall inside its instances on that thread; each span the harness
records ends in a device synchronisation, so its device work lies inside it.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

SPAN_PREFIX = "portbench."  # every span the harness records
WINDOW_SPAN = SPAN_PREFIX + "window"
TOP = 10
SHORT_GAP_S = 20e-6  # gaps this short are the launch rate, named together
NOT_KERNELS = ("Memcpy", "Memset")  # the profiler's names of copies and sets


class Tracer:
    """``torch.profiler`` over the window when ``enabled``; a no-op otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def profiling(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as self.prof:
            yield

    def span(self, name: str):
        """A named span in the trace (nothing when tracing is off)."""
        return torch.profiler.record_function(name) if self.enabled else contextlib.nullcontext()

    def summary(self) -> dict | None:
        """``{"busy_s", "window_s", "device_ops", "idle_gaps", "spans",
        "events"}`` (``spans``: {span name: {"count", "kernel_s"}}; ``events``
        counts the window's events by kind) or None (tracing off, or no window
        span found)."""
        if self.prof is None:
            return None
        return summarize(_events(self.prof))


def _call(e, name: str, default=None):
    """``e.<name>()``, or ``default`` where this version of PyTorch's event
    has no such method."""
    fn = getattr(e, name, None)
    return fn() if fn is not None else default


def _events(prof) -> list:
    """(name, start_s, end_s, on_device, thread, kind) of every profiled event.

    A span recorded on the host also shows on the device as an annotation
    over the device time it covers, and a wait on the host may show as a
    synchronisation record: neither is an operation, and both are dropped
    (by their kind where the event tells it, and by the harness's span names).
    """
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == cuda
        kind = _call(e, "activity_type", "")
        if on_device and (_call(e, "is_user_annotation", False) or "annotation" in kind
                          or "sync" in kind or name.startswith(SPAN_PREFIX)):
            continue
        start_ns = _call(e, "start_ns")
        start = start_ns * 1e-9 if start_ns is not None else e.start_us() * 1e-6
        dur_ns = _call(e, "duration_ns")
        end = start + (dur_ns * 1e-9 if dur_ns is not None else e.duration_us() * 1e-6)
        out.append((name, start, end, on_device, e.start_thread_id(),
                    kind or ("device" if on_device else "host")))
    return out


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged: list, starts: list, a: float, b: float) -> float:
    """Length of [a, b] that the disjoint, sorted intervals ``merged`` (their
    starts ``starts``) cover."""
    total = 0.0
    for lo, hi in merged[max(0, bisect.bisect_right(starts, a) - 1):]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


def summarize(events: list) -> dict | None:
    windows = [e for e in events if e[0] == WINDOW_SPAN and not e[3]]
    if not windows:
        return None
    _, w0, w1, _, thread, _ = windows[0]
    inside = [e for e in events if e[2] > w0 and e[1] < w1]
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b, dev, *_ in inside if dev])
    per_op, kinds = defaultdict(float), defaultdict(int)
    for name, a, b, dev, _, kind in inside:
        kinds[f"{'device' if dev else 'host'} {kind}"] += 1
        if dev:
            per_op[name] += min(b, w1) - max(a, w0)

    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))

    host = sorted((a, b, name) for name, a, b, dev, th, _ in inside
                  if not dev and th == thread and name != WINDOW_SPAN)
    kernels = _union([(a, b) for name, a, b, dev, *_ in inside
                      if dev and not name.startswith(NOT_KERNELS)])
    kernel_starts = [k[0] for k in kernels]
    spans = {}
    for a, b, name in host:
        if name.startswith(SPAN_PREFIX):
            span = spans.setdefault(name, {"count": 0, "kernel_s": 0.0})
            span["count"] += 1
            span["kernel_s"] += _covered(kernels, kernel_starts, a, b)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for a, b in gaps:
        if b - a < SHORT_GAP_S:
            idle[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += b - a
            continue
        mid = (a + b) / 2
        # the innermost open host event: the latest start before mid that is still open
        name = "host outside any operation"
        for j in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(
                starts, mid) - 4096), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += b - a

    def top(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": sum(b - a for a, b in busy), "window_s": w1 - w0,
            "device_ops": top(per_op), "idle_gaps": top(idle), "spans": spans,
            "events": dict(kinds)}
