"""The count functions against hand counts at small shapes."""

from __future__ import annotations

import pytest

from portbench.harness import bench

peaks = bench.counts("peaks")
sl_block = bench.counts("sl_block")
wb_gram = bench.counts("wb_gram")


def test_fold_sizes_are_kfold():
    assert sl_block.fold_sizes(10, 5) == [2] * 5
    assert sl_block.fold_sizes(12, 5) == [3, 3, 2, 2, 2]
    assert sum(sl_block.fold_sizes(8192, 5)) == 8192


def test_score_pairs_by_hand():
    # captions 2x2, images 2x2, both cross 2x2; imagery 3x3 and 3x(3+4), twice
    assert sl_block.score_pairs(4, 3) == 16 + 2 * (9 + 21)


def test_fixed_block_by_hand():
    # 2 vertices, N=4 train, 2 test, 3 imagery, K=3, D=5, 7 distinct columns
    t = sl_block.terms(4, 2, 3, 3, 5, 2, 0, 2, 7)
    assert t["gram"] == (2 * 4 * 3 * 4, 0)  # 6 distinct entries, 4 products, 2 flops each
    assert t["cross"] == (2 * 2 * 4 * 3 * 5, 0)
    assert t["refit_factor"] == (2 * 27 / 3, 0)
    assert t["predict"] == (2 * 2 * 5 * 3 * 8, 0)
    assert t["score_distances"] == (2 * 2 * 5 * sl_block.score_pairs(2, 3), 0)
    assert t["gather"] == (0, 7 * 9 * 4) and t["latents"] == (0, 9 * 5 * 4)
    assert "fold_factor" not in t


def test_cv_block_by_hand():
    # 1 vertex, N=5 in 2 folds (3, 2), K=2, D=4, 3 alphas
    t = sl_block.terms(5, 2, 3, 2, 4, 2, 3, 1, 2)
    assert t["fold_factor"] == (2 * 3 * 8 / 3, 0)
    assert t["fold_similarity"] == (3 * 2 * 2 * (9 + 4), 0)


def test_wb_gram_by_hand():
    t = wb_gram.terms(3, 2, 10)
    assert t["gram"] == (6 * 10 * 2, 0)  # 6 distinct entries of 10 products
    assert t["query"] == (2 * 3 * 10 * 2, 0)
    assert t["betas_in"] == (0, 5 * 10 * 4) and t["kernels_out"] == (0, (6 + 6) * 4)


def test_least_seconds_takes_the_larger_bound():
    s, by = peaks.least_seconds({"a": (67e12, 0), "b": (0, 1e12)})
    assert (s, by) == (pytest.approx(1.0), "operations")
    s, by = peaks.least_seconds({"a": (1.0, 3.35e12)})
    assert (s, by) == (pytest.approx(1.0), "bytes")


def test_full_size_cv_block_is_flop_bound():
    t = sl_block.terms(8192, 140, 3, 750, 1024, 5, 6, 128, 96000)
    s, by = peaks.least_seconds(t)
    assert by == "operations" and 0.2 < s < 0.4


def test_gram_roofline_reads_the_gram_spans_kernel_time():
    from types import SimpleNamespace

    cfg = {"n_test": 2, "n_imagery": 1, "n_features": 10}
    least = (peaks.least_seconds(wb_gram.terms(4, 3, 10))[0]
             + peaks.least_seconds(wb_gram.terms(2, 3, 10))[0])
    ctx = SimpleNamespace(config=cfg, counts=bench.counts, record={"gram_rows": [4, 2]},
                          trace={"spans": {"portbench.gram": {"count": 2, "kernel_s": 2e-9}}})
    share = bench.reader("wb_gram_roofline_share").read(ctx)
    assert share == pytest.approx(100.0 * least / 2e-9)
    ctx.trace = {"spans": {}}
    assert bench.reader("wb_gram_roofline_share").read(ctx) is None
