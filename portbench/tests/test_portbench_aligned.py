"""The aligned-gather reader on hand-made summaries: the counter a block, and
None where the counter was not recorded (a program without it, the float32
path, the profiler off) or the program has no record of its stages."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from multimodal_decoding_tpu_torch.utils import profiling
from portbench.harness import bench

METRIC = "sl_aligned_gathers.fastmath"
BLOCK = {"count": 4, "host_s": 1.0, "self_host_s": 1.0, "stream_s": 0.1}


def ctx(blocks=4):
    return SimpleNamespace(record={"blocks": blocks, "vertices": 85 * blocks})


def summary(counters):
    return {"spans": {"mdt.runner.block": BLOCK}, "counters": counters}


@pytest.mark.parametrize("gathers,blocks,value", [(4, 4, 1.0), (6, 4, 1.5), (1, 8, 0.125)])
def test_reader_value(monkeypatch, gathers, blocks, value):
    monkeypatch.setattr(profiling, "summary",
                        lambda: summary({"mdt.engine.aligned_gather": gathers,
                                         "mdt.precision.bf16": 4 * blocks}))
    assert bench.reader(METRIC).read(ctx(blocks)) == pytest.approx(value, rel=1e-12)


def test_reader_without_its_counter(monkeypatch):
    # nothing recorded; the float32 path's record and a program without the
    # counter (the bf16 products counted, no aligned gather); no blocks
    for s in ({"spans": {}, "counters": {}}, summary({"mdt.solve.blocked": 4}),
              summary({"mdt.precision.bf16": 16})):
        monkeypatch.setattr(profiling, "summary", lambda s=s: s)
        assert bench.reader(METRIC).read(ctx()) is None
    monkeypatch.setattr(profiling, "summary",
                        lambda: summary({"mdt.engine.aligned_gather": 4}))
    assert bench.reader(METRIC).read(ctx(0)) is None
    monkeypatch.delattr(profiling, "summary")
    assert bench.reader(METRIC).read(ctx()) is None
