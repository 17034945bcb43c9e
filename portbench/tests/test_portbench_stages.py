"""The readers of the program's stage totals, on hand-made summaries: each
metric's value, and None where no span was recorded or the program has no
record of its stages."""

from __future__ import annotations

import pytest

from multimodal_decoding_tpu_torch.utils import profiling
from portbench.harness import bench


def span(count, stream_s, host_s=1.0):
    return {"count": count, "host_s": host_s, "self_host_s": host_s, "stream_s": stream_s}


SL = {"spans": {"mdt.runner.block": span(4, 3.0), "mdt.engine.step": span(4, 2.9),
                "mdt.engine.select": span(4, 2.4), "mdt.engine.solve": span(4, 0.12)},
      "counters": {}}
WB = {"spans": {"mdt.gram.build": span(2, 1.6), "mdt.gram.h2d": span(40, 0.3),
                "mdt.gram.products": span(40, 1.0), "mdt.gram.stage": span(40, 0.0)},
      "counters": {"mdt.gram.h2d_bytes": 1.5e10}}

CASES = [
    ("sl_select_ms.cv", SL, 1e3 * 2.4 / 4),
    ("sl_solve_ms.cv", SL, 1e3 * 0.12 / 4),
    ("sl_solve_ms.fixed", SL, 1e3 * 0.12 / 4),
    ("sl_outside_step_ms.cv", SL, 1e3 * (3.0 - 2.9) / 4),
    ("sl_outside_step_ms.fixed", SL, 1e3 * (3.0 - 2.9) / 4),
    ("wb_gram_stall_s", WB, (1.6 - 0.3 - 1.0) / 2),
    ("wb_gram_h2d_gbps", WB, 15.0 / 0.3),
]


@pytest.mark.parametrize("metric,summary,value", CASES, ids=[c[0] for c in CASES])
def test_reader_value(monkeypatch, metric, summary, value):
    monkeypatch.setattr(profiling, "summary", lambda: summary)
    assert bench.reader(metric).read(None) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_without_spans(monkeypatch, metric):
    # nothing recorded (the profiler was off), the other kind of cell's spans,
    # spans with no stream time (the CPU), and a program without the record
    for summary in ({"spans": {}, "counters": {}}, WB if metric.startswith("sl_") else SL,
                    {"spans": {n: span(s["count"], None) for n, s in
                               {**SL["spans"], **WB["spans"]}.items()}, "counters": {}}):
        monkeypatch.setattr(profiling, "summary", lambda s=summary: s)
        assert bench.reader(metric).read(None) is None
    monkeypatch.delattr(profiling, "summary")
    assert bench.reader(metric).read(None) is None


def test_readers_of_the_new_metrics_are_in_the_benchmark():
    names = {m["name"]: m for m in bench.benchmark()["per_layer"]}
    for metric, *_ in CASES:
        assert names[metric]["source"] == "program_span"
        cells = names[metric]["workloads"]
        assert cells == (["sl-cv-null"] if metric.endswith(".cv") else
                         ["sl-fixed-null"] if metric.endswith(".fixed") else ["wb-cold"])
