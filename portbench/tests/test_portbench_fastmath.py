"""The 16-bit cell's readers on hand-made summaries: each metric's value, and
None where its span or counter was not recorded (the parent commit, the
float32 path, the profiler off) or the program has no record of its stages."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from multimodal_decoding_tpu_torch.utils import profiling
from portbench.harness import bench


def span(count, stream_s):
    return {"count": count, "host_s": 1.0, "self_host_s": 1.0, "stream_s": stream_s}


# 4 blocks of 85 vertices at K = 750, the fit's stream time 20 ms
FAST = {"spans": {"mdt.runner.block": span(4, 0.1), "mdt.engine.fit": span(4, 0.02)},
        "counters": {"mdt.precision.bf16": 16}}
CONFIG = dict(n_train=8192, n_test=140, n_imagery=3, latent_dim=1024, n_splits=5)


def ctx():
    return SimpleNamespace(record={"blocks": 4, "vertices": 340}, config=CONFIG,
                           driver=SimpleNamespace(adjacency=np.zeros((340, 750), np.int32)),
                           counts=bench.counts)


def fit_share():
    flops = 340 * 8192 * 750 * 751 + 340 * 2 * 8192 * 750 * 1024  # gram + cross
    return 100.0 * flops / 989.4e12 / 0.02


CASES = [("sl_fit_ms.fastmath", 1e3 * 0.02 / 4), ("sl_fit_ms.fixed", 1e3 * 0.02 / 4),
         ("sl_bf16_products.fastmath", 4.0), ("sl_fit_roofline_share.fastmath", fit_share())]


@pytest.mark.parametrize("metric,value", CASES, ids=[c[0] for c in CASES])
def test_reader_value(monkeypatch, metric, value):
    monkeypatch.setattr(profiling, "summary", lambda: FAST)
    assert bench.reader(metric).read(ctx()) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_without_its_span_or_counter(monkeypatch, metric):
    # nothing recorded, the float32 path's record (no fit span, no counter:
    # the parent commit's), spans with no stream time (the CPU)
    float32 = {"spans": {"mdt.runner.block": span(4, 0.1), "mdt.engine.solve": span(4, 0.02)},
               "counters": {"mdt.solve.blocked": 4}}
    cpu = {"spans": {n: span(s["count"], None) for n, s in FAST["spans"].items()},
           "counters": {}}
    for summary in ({"spans": {}, "counters": {}}, float32, cpu):
        monkeypatch.setattr(profiling, "summary", lambda s=summary: s)
        assert bench.reader(metric).read(ctx()) is None
    monkeypatch.delattr(profiling, "summary")
    assert bench.reader(metric).read(ctx()) is None

