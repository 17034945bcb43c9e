"""Cross-package adjacency through the shared cache, on a mesh full of ties.

On a regular icosphere many neighbours are exactly equidistant, and the two
packages' exact kNN (sklearn there, scipy's cKDTree here) keep different
ones at the k-th place.  Both packages key and store the adjacency cache
alike, so whichever package writes it, the other reads the same neighbours
and the two searchlight runners give equal scores.
"""

import jax
import numpy as np
import pytest

from multimodal_decoding_tpu.decoding import searchlight as JS
from multimodal_decoding_tpu.io.surface import icosphere
from multimodal_decoding_tpu.parallel.mesh import vertex_mesh
from multimodal_decoding_tpu.parallel.searchlight_runner import (
    run_searchlight as jax_run_searchlight,
)
from multimodal_decoding_tpu_torch.decoding import searchlight as TS
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
    run_searchlight as torch_run_searchlight,
)
from tests.test_torch_searchlight_engine import N_IMAG, N_TEST, N_TRAIN, STIM_TYPES

K_NN = 6


def _build(package, coords, cache_dir):
    if package == "jax":
        return JS.build_adjacency(coords, None, None, K_NN, cache_dir=cache_dir)[0]
    return TS.build_adjacency(coords, None, None, K_NN, cache_dir=cache_dir, device="cpu")[0]


def _problem(n_vertices, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(N_TRAIN + N_TEST + N_IMAG, n_vertices).astype(np.float32)
    return dict(X_train=X[:N_TRAIN], X_test=X[N_TRAIN:N_TRAIN + N_TEST],
                X_imag=X[N_TRAIN + N_TEST:], Y_train=rng.randn(N_TRAIN, 8).astype(np.float32),
                Y_test=rng.randn(N_TEST, 8).astype(np.float32),
                Y_imag=rng.randn(N_IMAG, 8).astype(np.float32), stim_types_test=STIM_TYPES)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_one_package_writes_the_cache_the_other_reads_it(tmp_path, writer, reader):
    coords = icosphere(1, 50.0).coordinates  # regular: exact distance ties
    own = {p: _build(p, coords, None) for p in ("jax", "torch")}
    tied_rows = (np.sort(own["jax"], 1) != np.sort(own["torch"], 1)).any(1)
    assert tied_rows.sum() > 0  # without the cache the neighbour sets differ

    cache = str(tmp_path / "adjacency_cache")
    written = _build(writer, coords, cache)
    np.testing.assert_array_equal(written, own[writer])
    read = _build(reader, coords, cache)
    np.testing.assert_array_equal(read, written)

    prob = _problem(len(coords))
    common = dict(alpha=10.0, block_size=16, progress=False)
    ref, _ = jax_run_searchlight(**prob, adjacency=_build("jax", coords, cache),
                                 mesh=vertex_mesh(jax.devices()[:1]), **common)
    got, _ = torch_run_searchlight(**prob, adjacency=_build("torch", coords, cache),
                                   device="cpu", **common)
    assert sorted(got) == sorted(ref)
    for m in ref:
        np.testing.assert_array_equal(got[m], ref[m], err_msg=m)
