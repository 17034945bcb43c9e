"""Port parity: per-rank input shards and their assembly (parallel/multihost.py).

The port runs real gloo worlds of 2 and 3 CPU processes (``spawn_world``)
where the JAX package emulates hosts at device granularity in one process.
Every rank's assembled tensors must equal the dense concatenation of the
inputs exactly, each beta file must be read by one rank only, and a world
with more ranks than files must fail on every rank before any collective.
"""

import os

import numpy as np
import pytest

from multimodal_decoding_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from multimodal_decoding_tpu.parallel.multihost import host_shard_bounds as jax_bounds
from multimodal_decoding_tpu_torch.io.gifti import write_gifti
from multimodal_decoding_tpu_torch.parallel import multihost as MH
from multimodal_decoding_tpu_torch.parallel.mesh import pad_to_multiple, spawn_world

N_ROWS, N_COLS, N_SUBJ, N_FILES = 12, 7, 5, 5
WORLD_TIMEOUT_S = 120


def _inputs():
    rng = np.random.RandomState(0)
    rows = rng.randn(N_ROWS, N_COLS).astype(np.float32)
    nulls = rng.rand(N_SUBJ, 3, N_COLS).astype(np.float32)
    nulls[1, :, 2] = np.nan  # a subject's NaN vertex
    nulls[4, 0, :] = np.nan
    files = rng.randn(N_FILES, N_COLS).astype(np.float32)
    return rows, nulls, files


def _multihost_rank(paths):
    """One rank's calls of every assembly function, as host numpy."""
    from multimodal_decoding_tpu_torch.parallel.mesh import vertex_mesh

    mesh = vertex_mesh("cpu")
    rows, nulls, _ = _inputs()
    lo, hi = MH.host_shard_bounds(N_ROWS, mesh.rank, mesh.size)
    out = {"rank": mesh.rank,
           "replicated": MH.replicate_rows(rows[lo:hi], lo, N_ROWS, mesh).numpy()}
    shard = MH.shard_rows_from_host(rows, mesh)
    out["shard"] = shard.numpy()
    out["gathered"] = MH.host_numpy(shard, mesh)
    out["host_copy"] = MH.host_numpy(shard)
    out["on_host"] = MH.replicated_from_host(rows, mesh).numpy()

    slo, shi = MH.host_shard_bounds(N_SUBJ, mesh.rank, mesh.size)
    fill = np.zeros_like(nulls)
    fill[slo:shi] = nulls[slo:shi]
    out["filled"] = MH.replicate_host_filled(fill, mesh).numpy()

    read = []
    real_load = MH.load_beta_rows

    def load(ps):
        read.extend(ps)
        return real_load(ps)

    MH.load_beta_rows = load
    X, n = MH.distributed_beta_matrix(paths, mesh, pad_value=-1.0)
    MH.load_beta_rows = real_load
    out.update(beta_matrix=X.numpy(), beta_n=n, read=read)

    errors = []
    for call in (lambda: MH.distributed_beta_matrix(paths[:mesh.size - 1], mesh),
                 lambda: MH.replicate_rows(rows[lo:hi], lo + 1, N_ROWS, mesh),
                 lambda: MH.replicate_rows(rows[:1], 0, N_ROWS + 1, mesh)):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    _, _, files = _inputs()
    paths = []
    for i, row in enumerate(files):
        paths.append(os.path.join(tmp, f"beta_{i}.gii"))
        write_gifti(paths[-1], row)
    return {w: spawn_world(_multihost_rank, w, args=(paths,), timeout_s=WORLD_TIMEOUT_S)
            for w in (2, 3)}, paths


@pytest.mark.parametrize("n,w", [(0, 1), (1, 3), (5, 2), (7, 3), (12, 4), (13, 8), (100, 7)])
def test_host_shard_bounds_cover_every_row_once(n, w):
    bounds = [MH.host_shard_bounds(n, r, w) for r in range(w)]
    assert bounds == [jax_bounds(n, r, w) for r in range(w)]
    owned = np.concatenate([np.arange(lo, hi) for lo, hi in bounds])
    np.testing.assert_array_equal(owned, np.arange(n))
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1
    with pytest.raises(ValueError, match="out of range"):
        MH.host_shard_bounds(n, w, w)


@pytest.mark.parametrize("axis,fill", [(0, None), (1, None), (0, -1.0), (1, 7.0)])
def test_pad_to_multiple_matches_jax(axis, fill):
    arr = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    for multiple in (1, 2, 4, 5):
        got, n_got = pad_to_multiple(arr, multiple, axis=axis, fill=fill)
        ref, n_ref = jax_pad_to_multiple(arr, multiple, axis=axis, fill=fill)
        np.testing.assert_array_equal(got, ref)
        assert n_got == n_ref == arr.shape[axis]


@pytest.mark.parametrize("w", [2, 3])
def test_replicate_rows_equals_the_dense_concatenation(worlds, w):
    rows, _, _ = _inputs()
    for out in worlds[0][w]:
        np.testing.assert_array_equal(out["replicated"], rows)
        np.testing.assert_array_equal(out["on_host"], rows)


@pytest.mark.parametrize("w", [2, 3])
def test_shard_rows_and_host_numpy(worlds, w):
    rows, _, _ = _inputs()
    for out in worlds[0][w]:
        lo, hi = MH.host_shard_bounds(N_ROWS, out["rank"], w)
        np.testing.assert_array_equal(out["shard"], rows[lo:hi])
        np.testing.assert_array_equal(out["host_copy"], rows[lo:hi])
        np.testing.assert_array_equal(out["gathered"], rows)


@pytest.mark.parametrize("w", [2, 3])
def test_replicate_host_filled_keeps_nan_rows(worlds, w):
    _, nulls, _ = _inputs()
    for out in worlds[0][w]:
        np.testing.assert_array_equal(out["filled"], nulls)  # NaN where NaN, exactly


@pytest.mark.parametrize("w", [2, 3])
def test_distributed_beta_matrix_reads_each_file_once(worlds, w):
    results, paths = worlds
    _, _, files = _inputs()
    n_padded = -(-N_FILES // w) * w
    expected = np.concatenate([files, np.full((n_padded - N_FILES, N_COLS), -1.0, np.float32)])
    for out in results[w]:
        np.testing.assert_array_equal(out["beta_matrix"], expected)
        assert out["beta_n"] == N_FILES
    assert sorted(p for out in results[w] for p in out["read"]) == sorted(paths)


@pytest.mark.parametrize("w", [2, 3])
def test_bad_shards_raise_on_every_rank(worlds, w):
    for out in worlds[0][w]:
        starved, misplaced, indivisible = out["errors"]
        assert starved is not None and "own only padding rows" in starved
        assert misplaced is not None and "expected" in misplaced
        assert indivisible is not None and "divisible" in indivisible
