"""The pieces a padded, masked adjacency brings: the float64 balls, the plain
reference over neighbourhoods of any sizes, the check's excuse for a
neighbour on the radius, and the roofline's reading of a mask and the
panel launches' reader, against hand-made inputs."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import bench, data, judge
from portbench.reference import searchlight as SL
from portbench.reference import searchlight_radius as RR
from portbench.tests.tiny import CELLS, tiny_cell

COORDS = data.icosphere_coords(2, 100.0)


def test_balls_hold_every_vertex_within_the_radius():
    verts = np.array([0, 5, 77, 161])
    balls = RR.balls(COORDS, verts, 56.0, chunk=3)
    c = COORDS.astype(np.float64)
    for v, ball in zip(verts, balls):
        d2 = ((c - c[v]) ** 2).sum(axis=1)
        assert np.array_equal(ball, np.nonzero(d2 <= 56.0 ** 2)[0])
        assert v in ball
        assert np.allclose(RR.squared_distances(COORDS, v, ball), d2[ball])


def _inputs(n_train=30, n_test=8, n_imag=3, d=4, v=len(COORDS), p=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn((n_train + n_test + n_imag, v), generator=gen)
    Y = torch.randn((n_train + n_test + n_imag, d), generator=gen)
    rows = torch.arange(n_test)
    shuffles = torch.stack([torch.cat([torch.randperm(n_test // 2, generator=gen),
                                       n_test // 2 + torch.randperm(n_test // 2, generator=gen)])
                            for _ in range(p)])
    return X, (Y[:n_train], Y[n_train:n_train + n_test], Y[n_train + n_test:],
               rows[:n_test // 2], rows[n_test // 2:], shuffles)


@pytest.mark.parametrize("alphas", [None, [1.0, 10.0, 100.0]])
def test_reference_of_mixed_sizes_is_each_vertex_alone(alphas):
    """Vertices of different ball sizes, grouped by size, give what each
    vertex gives through the k-NN reference alone, in the caller's order."""
    X, rest = _inputs()
    verts = np.array([3, 40, 12, 0, 99])
    balls = RR.balls(COORDS, verts, 56.0)
    assert len({len(b) for b in balls}) > 1
    der = torch.tensor([[0, 1, 1], [1, 0, 1], [0, 0, 1], [1, 1, 0], [0, 1, 0]])
    kw = dict(alpha=1.0, alphas=alphas, n_splits=3, chunk=2)
    got = RR.vertices(X, balls, *rest, der, **kw)
    for i, ball in enumerate(balls):
        one = SL.vertices(X, torch.as_tensor(ball[None]), *rest, der[i:i + 1], **kw)
        for key in ("scores", "null"):
            for m in one[key]:
                assert np.array_equal(got[key][m][i], one[key][m][0]), (key, m)
        if alphas is not None:
            assert got["alpha"][i] == one["alpha"][0]
            assert np.array_equal(got["cv"][i], one["cv"][0])


def _ctx(mask, adjacency, alphas=6, busy_s=1.0):
    cfg = {"n_train": 8192, "n_test": 140, "n_imagery": 3, "latent_dim": 1024, "n_splits": 5}
    B = 4
    return SimpleNamespace(
        config=cfg, traffic={"alphas": [1.0] * alphas}, counts=bench.counts,
        driver=SimpleNamespace(mask=mask, adjacency=adjacency),
        record={"blocks": len(mask) // B, "block_size": B,
                "block_ids": list(range(len(mask) // B))},
        trace={"busy_s": busy_s})


def test_roofline_credits_live_columns_only():
    """Each vertex at its own live count, the gather at the block's distinct
    live columns; the padded columns add nothing."""
    sl_block, peaks = bench.counts("sl_block"), bench.counts("peaks")
    kmax = 12
    live = np.array([12, 10, 10, 7, 12, 12, 9, 8])
    mask = np.arange(kmax)[None, :] < live[:, None]
    adjacency = np.arange(len(live) * kmax).reshape(len(live), kmax) % 50
    cfg = _ctx(mask, adjacency).config
    want = 0.0
    for b in range(2):
        rows = slice(4 * b, 4 * b + 4)
        terms = [sl_block.terms(cfg["n_train"], cfg["n_test"], cfg["n_imagery"], int(k),
                                cfg["latent_dim"], 5, 6, 1, 0) for k in live[rows]]
        flops = sum(f for t in terms for f, _ in t.values())
        cols = np.unique(adjacency[rows][mask[rows]]).size
        nbytes = cols * 8335 * 4 + 8335 * 1024 * 4
        want += max(flops / peaks.FP32_FLOP_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
    got = bench.reader("sl_roofline_share").read(_ctx(mask, adjacency, busy_s=2.0))
    assert got == pytest.approx(100.0 * want / 2.0)


def test_roofline_without_a_mask_counts_the_whole_width():
    """A k-NN adjacency (no mask) is counted as one block of the adjacency's
    width, exactly; a mask with nothing padded reads the same."""
    sl_block, peaks = bench.counts("sl_block"), bench.counts("peaks")
    adjacency = np.arange(8 * 12).reshape(8, 12) % 50
    ctx = _ctx(np.ones((8, 12), dtype=bool), adjacency, busy_s=3.0)
    cfg = ctx.config
    want = sum(peaks.least_seconds(sl_block.terms(
        cfg["n_train"], cfg["n_test"], cfg["n_imagery"], 12, cfg["latent_dim"], 5, 6, 4,
        int(np.unique(adjacency[4 * b:4 * b + 4]).size)))[0] for b in range(2))
    full = bench.reader("sl_roofline_share").read(ctx)
    ctx.driver = SimpleNamespace(adjacency=adjacency)
    assert bench.reader("sl_roofline_share").read(ctx) == 100.0 * want / 3.0 == full


def test_roofline_reads_nothing_without_a_trace():
    ctx = _ctx(np.ones((8, 4), dtype=bool), np.zeros((8, 4), dtype=np.int32))
    ctx.trace = None
    assert bench.reader("sl_roofline_share").read(ctx) is None
    ctx = _ctx(np.ones((8, 4), dtype=bool), np.zeros((8, 4), dtype=np.int32), busy_s=0.0)
    assert bench.reader("sl_roofline_share").read(ctx) is None


def test_panel_launches_a_block():
    read = bench.reader("sl_panel_launches").read
    assert read(SimpleNamespace(record={"panel_launches": 980, "blocks": 4})) == 245
    assert read(SimpleNamespace(record={"panel_launches": 0, "blocks": 4})) is None
    assert read(SimpleNamespace(record={"blocks": 4})) is None


@pytest.mark.parametrize("name", [c for c in CELLS if "radius" in tiny_cell(c)[0]])
def test_a_neighbour_on_the_radius_is_excused_and_left_out(name):
    """A live set that differs from the float64 ball only by a neighbour on the
    radius itself (as float32 rounding may place it) is no membership miss;
    that vertex leaves the comparison of answers and is counted apart."""
    config, traffic, kind = tiny_cell(name)
    drv = bench.module("drivers", kind).Driver(config, traffic, 3, "cpu")
    drv.setup()
    drv.window(0.1)
    drv.release()
    c = drv.coords.astype(np.float64)
    verts = drv.sample()
    # the largest squared distance inside any ball: a radius with the same balls,
    # some neighbour lying on it exactly
    d2 = [((c[drv.adjacency[v][drv.mask[v]]] - c[v]) ** 2).sum(axis=1) for v in range(len(c))]
    r2 = max(float(d.max()) for d in d2)
    drv.cfg = dict(drv.cfg, radius=float(np.sqrt(r2)))
    assert drv.check()["ball_band_vertices"] == 0
    on_radius = [v for v in verts if np.isclose(d2[v], r2, rtol=1e-12).any()]
    assert on_radius
    mask = drv.mask.copy()
    for v in on_radius:
        mask[v, np.nonzero(np.isclose(d2[v], r2, rtol=1e-12))[0][0]] = False
    drv.mask = mask
    numbers = drv.check()
    assert numbers["membership_misses"] == 0.0
    assert numbers["ball_band_vertices"] == len(on_radius) < len(verts)
    assert judge.verdict(numbers, traffic["limits"])[0], numbers
