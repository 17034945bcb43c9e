"""Port parity: TFCE and clusters (``ops/tfce.py`` + ``native/tfce.cpp``).

The port keeps its own copy of the JAX package's TFCE module and C++
engine, built at first use by ``ops/_host_build``.  On the cases of
``tests/test_tfce.py`` the copy is bit-equal to the JAX package's on both
backends, and its native engine agrees with its numpy one.  A failed build
raises with the compiler's output: there is no silent numpy fallback.
"""

import numpy as np
import pytest

from multimodal_decoding_tpu.io.surface import edge_lengths as jax_edge_lengths
from multimodal_decoding_tpu.io.surface import edge_lengths_dict as jax_edge_lengths_dict
from multimodal_decoding_tpu.io.surface import icosphere
from multimodal_decoding_tpu.ops import tfce as JT
from multimodal_decoding_tpu_torch.io import surface as TSurf
from multimodal_decoding_tpu_torch.ops import _host_build
from multimodal_decoding_tpu_torch.ops import tfce as TT


@pytest.fixture(scope="module")
def mesh():
    return icosphere(subdivisions=2, radius=50.0)  # 162 vertices


def make_tmap(rng, v):
    vals = rng.randn(v).astype(np.float32) * 1.5 + 0.5
    vals[rng.choice(v, size=v // 10, replace=False)] = np.nan
    return vals


def _maps(mesh):
    """The maps of tests/test_tfce.py: NaN-holed t-maps, a magnitude/sparsity
    fuzz, uniform and degenerate maps."""
    v = mesh.n_vertices
    rng = np.random.RandomState(0)
    maps = [make_tmap(rng, v) for _ in range(6)]
    for seed in range(8):
        r = np.random.RandomState(seed)
        scale = 10.0 ** r.uniform(-2, 2)
        vals = (r.randn(v) * scale + r.uniform(-1, 1) * scale).astype(np.float32)
        vals[r.rand(v) < r.uniform(0, 0.5)] = np.nan
        maps.append(vals)
    maps += [np.full(v, 2.0, np.float32), np.full(v, np.nan, np.float32),
             np.full(v, -1.0, np.float32), np.zeros(v, np.float32)]
    return np.stack(maps)


def test_mesh_edges_are_copies(mesh):
    te, tl = TSurf.edge_lengths(mesh)
    je, jl = jax_edge_lengths(mesh)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(TSurf.mesh_edges(mesh), je)
    assert TSurf.edge_lengths_dict(mesh) == jax_edge_lengths_dict(mesh)


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("dh,extents", [(0.1, "num_vertices"), (0.2, "edge_lengths"),
                                        (0, "num_vertices"), (0.5, "num_vertices")])
def test_tfce_is_bit_equal_to_jax(mesh, backend, dh, extents):
    edges, lens = jax_edge_lengths(mesh)
    maps = _maps(mesh)
    ref = JT.tfce_map(maps, edges, lens, dh=dh, cluster_extents_measure=extents,
                      backend="numpy" if backend == "numpy" else "auto")
    got = TT.tfce_map(maps, edges, lens, dh=dh, cluster_extents_measure=extents,
                      backend=backend)
    assert got.dtype == np.float32 and got.shape == maps.shape
    np.testing.assert_array_equal(got, ref)


def test_tfce_no_edges_and_threads(mesh):
    v = mesh.n_vertices
    vals = np.random.RandomState(0).rand(3, v).astype(np.float32) * 3
    no_edges = np.zeros((0, 2), dtype=np.int32)
    for backend in ("numpy", "native"):
        np.testing.assert_array_equal(
            TT.tfce_map(vals, no_edges, np.zeros(0), dh=0.3, backend=backend),
            JT.tfce_map(vals, no_edges, np.zeros(0), dh=0.3,
                        backend="numpy" if backend == "numpy" else "auto"))
    edges, lens = jax_edge_lengths(mesh)
    maps = np.random.RandomState(3).randn(8, v).astype(np.float32) * 2.0
    base = TT.tfce_map_native(maps, edges, lens, n_threads=1)
    for nt in (2, 4):
        np.testing.assert_array_equal(TT.tfce_map_native(maps, edges, lens, n_threads=nt), base)


def test_native_matches_numpy_backend(mesh):
    edges, lens = jax_edge_lengths(mesh)
    for i, vals in enumerate(_maps(mesh)):
        scale = max(float(np.nanmax(np.abs(vals))), 1e-9) if not np.all(np.isnan(vals)) else 1.0
        for dh, extents in ((0.1, "num_vertices"), (0.2, "edge_lengths")):
            ref = TT.tfce_map_numpy(vals, edges, lens, dh=dh * scale,
                                    cluster_extents_measure=extents)
            nat = TT.tfce_map_native(vals[None], edges, lens, dh=dh * scale,
                                     cluster_extents_measure=extents)[0]
            denom = max(float(np.max(np.abs(ref))), 1e-9)
            assert np.max(np.abs(nat - ref)) / denom < 1e-4, (i, dh, extents)


def test_calc_clusters_and_calc_tfce_values_equal_jax(mesh):
    edges, lens = jax_edge_lengths(mesh)
    vals = make_tmap(np.random.RandomState(1), mesh.n_vertices)
    for th in [0.0, 0.5, 1.5]:
        kw = dict(return_clusters=True, return_cluster_edge_lengths=True,
                  return_agg_t_values=True, return_cluster_map=True)
        got = TT.calc_clusters(vals, th, edges, lens, **kw)
        ref = JT.calc_clusters(vals, th, edges, lens, **kw)
        assert got["clusters"] == ref["clusters"]
        assert got["agg_t_values"] == ref["agg_t_values"]
        assert got["cluster_edge_lengths"] == ref["cluster_edge_lengths"]
        np.testing.assert_array_equal(got["cluster_map"], ref["cluster_map"])
    t_values = {h: {"m": make_tmap(np.random.RandomState(i), mesh.n_vertices)}
                for i, h in enumerate(("left", "right"))}
    by_hemi = {h: edges for h in t_values}
    lens_by_hemi = {h: lens for h in t_values}
    got = TT.calc_tfce_values(t_values, by_hemi, "m", edge_lengths_by_hemi=lens_by_hemi)
    ref = JT.calc_tfce_values(t_values, by_hemi, "m", edge_lengths_by_hemi=lens_by_hemi)
    for h in t_values:
        np.testing.assert_array_equal(got[h]["m"], ref[h]["m"])


def test_failed_build_raises_with_compiler_output(monkeypatch, mesh):
    monkeypatch.setattr(_host_build, "CXXFLAGS", ("-O3", "--no-such-compiler-flag"))
    with pytest.raises(RuntimeError, match="no-such-compiler-flag"):
        _host_build.build("tfce.cpp")
    monkeypatch.setattr(TT, "_native", None)  # as before the first use
    edges, lens = jax_edge_lengths(mesh)
    with pytest.raises(RuntimeError, match="building tfce.cpp failed"):
        TT.tfce_map(np.ones((1, mesh.n_vertices), np.float32), edges, lens)
    with pytest.raises(ValueError, match="unknown TFCE backend"):
        TT.tfce_map(np.ones((1, mesh.n_vertices), np.float32), edges, lens, backend="gpu")
