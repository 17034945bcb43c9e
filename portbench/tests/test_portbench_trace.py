"""The traced run's reduction from profiler events to busy time and gaps."""

from __future__ import annotations

import pytest

from portbench.harness.trace import WINDOW_SPAN, summarize

W = (WINDOW_SPAN, 1.0, 2.0, False, 7, "user_annotation")


def host(name, a, b, thread=7):
    return (name, a, b, False, thread, "cpu_op")


def dev(name, a, b):
    return (name, a, b, True, 0, "kernel")


def test_union_clipped_to_the_window():
    events = [W, dev("k1", 0.5, 1.2), dev("k2", 1.1, 1.3), dev("k2", 1.5, 1.6),
              dev("copy", 1.55, 1.7), dev("k3", 1.9, 2.5), host("aten::cat", 1.3, 1.5)]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.3 + 0.2 + 0.1)
    ops = dict(s["device_ops"])
    assert ops["k2"] == pytest.approx(0.3) and ops["k1"] == pytest.approx(0.2)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::cat"] == pytest.approx(0.2)  # the gap 1.3-1.5
    assert gaps["host outside any operation"] == pytest.approx(0.2)  # 1.7-1.9


def test_innermost_host_event_names_the_gap():
    events = [W, dev("k", 1.0, 1.4), dev("k", 1.6, 2.0), host("portbench.decode", 1.0, 2.0),
              host("aten::item", 1.45, 1.58), host("aten::cat", 1.41, 1.49, thread=9)]
    assert dict(summarize(events)["idle_gaps"]) == {"aten::item": pytest.approx(0.2)}


def test_short_gaps_are_named_together():
    events = [W] + [dev("k", 1.0 + i * 1e-4, 1.0 + i * 1e-4 + 9e-5) for i in range(10000)]
    gaps = dict(summarize(events)["idle_gaps"])
    assert gaps["gaps under 20 us"] == pytest.approx(10000 * 1e-5, rel=1e-6)


def test_no_window_no_summary():
    assert summarize([dev("k", 0.0, 1.0)]) is None


def test_span_kernel_time_leaves_out_copies():
    events = [W, host("portbench.gram", 1.0, 1.4), host("portbench.gram", 1.5, 1.9),
              dev("gemm", 1.05, 1.2), dev("gemm", 1.15, 1.25), dev("Memcpy HtoD", 1.0, 1.3),
              dev("Memset (Device)", 1.3, 1.35), dev("gemm", 1.6, 1.7),
              dev("scores", 1.42, 1.48), host("portbench.gram", 1.5, 1.9, thread=9)]
    spans = summarize(events)["spans"]
    assert spans["portbench.gram"]["count"] == 2
    assert spans["portbench.gram"]["kernel_s"] == pytest.approx(0.2 + 0.1)
