"""The staged-upload reader on hand-made summaries: the counter a block, and
None where the counter was not recorded (a program without it, the CPU
path, the profiler off) or the program has no record of its stages."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from multimodal_decoding_tpu_torch.utils import profiling
from portbench.harness import bench

METRIC = "sl_staged_uploads.fixed"
BLOCK = {"count": 4, "host_s": 1.0, "self_host_s": 1.0, "stream_s": 0.1}


def ctx(blocks=4):
    return SimpleNamespace(record={"blocks": blocks, "vertices": 85 * blocks})


def summary(counters):
    return {"spans": {"mdt.runner.block": BLOCK}, "counters": counters}


@pytest.mark.parametrize("uploads,blocks,value", [(4, 4, 1.0), (3, 4, 0.75), (32, 32, 1.0)])
def test_reader_value(monkeypatch, uploads, blocks, value):
    monkeypatch.setattr(profiling, "summary",
                        lambda: summary({"mdt.runner.staged_upload": uploads,
                                         "mdt.solve.blocked": blocks}))
    assert bench.reader(METRIC).read(ctx(blocks)) == pytest.approx(value, rel=1e-12)


def test_reader_without_its_counter(monkeypatch):
    # nothing recorded; a program without the counter (the parent's record:
    # its solves and bf16 products counted, no staged upload); no blocks
    for s in ({"spans": {}, "counters": {}}, summary({"mdt.solve.blocked": 4}),
              summary({"mdt.precision.bf16": 16, "mdt.engine.aligned_gather": 4})):
        monkeypatch.setattr(profiling, "summary", lambda s=s: s)
        assert bench.reader(METRIC).read(ctx()) is None
    monkeypatch.setattr(profiling, "summary",
                        lambda: summary({"mdt.runner.staged_upload": 4}))
    assert bench.reader(METRIC).read(ctx(0)) is None
    monkeypatch.delattr(profiling, "summary")
    assert bench.reader(METRIC).read(ctx()) is None
