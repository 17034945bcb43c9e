"""Port parity: the multi-GPU steps over ``torch.distributed``, on gloo CPU worlds.

Real worlds of 2 and 4 processes (``parallel/mesh.spawn_world``) run the
port's sharded steps; the JAX package runs its own on the 8-virtual-device
CPU mesh of one process.  Tolerances: the feature-sharded gram sums its
partial products in another order (atol 1e-4, the JAX test's bar);
group-null t-maps atol 1e-5; the sharded CV block (``"schur-pallas"``: the
port's panel-kernel plain version, the JAX Pallas kernel in interpret mode)
equal alphas and scores within 1e-4; the vertex-sharded runner with CV,
nulls, a killed run and its resume: equal alphas and nulls, scores within
rtol 2e-5 / atol 2e-6 (tests/test_multiprocess_distributed.py's bar)
against the port's one-device run and the JAX runner; the
permutation-sharded group null: ``null_max`` rtol 1e-5 against the JAX
package's one-process run, equal p-values and masks, and no file written by
any rank but 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from multimodal_decoding_tpu.io.surface import icosphere
from multimodal_decoding_tpu.parallel.mesh import feature_mesh as jax_feature_mesh
from multimodal_decoding_tpu.parallel.mesh import vertex_mesh as jax_vertex_mesh
from multimodal_decoding_tpu_torch.parallel.mesh import spawn_world

WORLD_TIMEOUT_S = 180
# the ops problem: f = 37 features (divisible by neither 2 nor 4)
N_TRAIN, N_TEST, N_IMAG, D, F = 20, 10, 3, 4, 37
S, P_WITHIN, V, N_GROUP = 4, 6, 30, 16
B, K = 8, 6
ALPHAS = [1e-1, 1e1, 1e3]
STIM_TYPES = np.array(["caption"] * 5 + ["image"] * 5)
# the runner problem: icosphere(3), 642 vertices in blocks of 64 (uneven last block)
RUN_BLOCK, RUN_K, RUN_P, CKPT_EVERY, DIE_AT_CALL = 64, 6, 4, 2, 6


def _ops_inputs():
    rng = np.random.RandomState(0)
    betas = [rng.randn(n, F).astype(np.float32) for n in (N_TRAIN, N_TEST, N_IMAG)]
    nulls = (0.5 + 0.1 * rng.randn(S, P_WITHIN, V)).astype(np.float32)
    X_all = rng.randn(N_TRAIN + N_TEST + N_IMAG, V).astype(np.float32)
    Y = [rng.randn(n, D).astype(np.float32) for n in (N_TRAIN, N_TEST, N_IMAG)]
    idx = np.stack([rng.choice(V, size=K, replace=False) for _ in range(B)]).astype(np.int32)
    return betas, nulls, X_all, Y, idx


def _ops_rank():
    """One rank's sharded gram, GramCache, null t-maps and CV block."""
    from multimodal_decoding_tpu_torch.decoding.searchlight_engine import TestLayout
    from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache
    from multimodal_decoding_tpu_torch.ops.stats import group_permutations
    from multimodal_decoding_tpu_torch.parallel import distributed as TD
    from multimodal_decoding_tpu_torch.parallel.mesh import feature_mesh, vertex_mesh

    betas, nulls, X_all, Y, idx = _ops_inputs()
    mesh_f, mesh_v = feature_mesh("cpu"), vertex_mesh("cpu")
    cache = GramCache(*betas, mesh=mesh_f)
    step = TD.sharded_searchlight_cv_step(mesh_v, TestLayout.from_stim_types(STIM_TYPES),
                                          N_TRAIN, N_TEST, ALPHAS, cv_solver="schur-pallas")
    perms = group_permutations(P_WITHIN, S, N_GROUP)
    return {
        "gram": TD.sharded_gram(betas[0], mesh_f).numpy(),
        "K": cache.K.numpy(), "K_test": cache.K_test.numpy(), "K_imag": cache.K_imag.numpy(),
        "null_t": TD.sharded_null_t_maps(nulls, perms, 0.5, mesh_v).numpy(),
        "cv": {m: v.numpy() for m, v in step(X_all, *Y, idx).items()},
    }


@pytest.fixture(scope="module")
def ops_worlds():
    return {w: spawn_world(_ops_rank, w, timeout_s=WORLD_TIMEOUT_S) for w in (2, 4)}


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_gram_and_feature_sharded_gram_cache_match_jax(ops_worlds, w):
    from multimodal_decoding_tpu.decoding.whole_brain import GramCache
    from multimodal_decoding_tpu.parallel.distributed import sharded_gram

    betas = _ops_inputs()[0]
    mesh = jax_feature_mesh()
    padded = np.pad(betas[0], ((0, 0), (0, -F % len(jax.devices()))))  # zero columns add 0
    ref = np.asarray(sharded_gram(
        jax.device_put(padded, NamedSharding(mesh, PartitionSpec(None, "f"))), mesh))
    cache = GramCache(*betas, mesh=mesh)
    for out in ops_worlds[w]:
        np.testing.assert_allclose(out["gram"], ref, rtol=0, atol=1e-4)
        for name in ("K", "K_test", "K_imag"):
            np.testing.assert_allclose(out[name], np.asarray(getattr(cache, name)),
                                       rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_null_t_maps_match_jax(ops_worlds, w):
    from multimodal_decoding_tpu.ops.stats import group_permutations
    from multimodal_decoding_tpu.parallel.distributed import sharded_null_t_maps

    nulls = _ops_inputs()[1]
    ref = np.asarray(sharded_null_t_maps(nulls, group_permutations(P_WITHIN, S, N_GROUP), 0.5,
                                         jax_vertex_mesh()))
    for out in ops_worlds[w]:
        assert out["null_t"].shape == (N_GROUP, V)
        np.testing.assert_allclose(out["null_t"], ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_searchlight_cv_step_matches_jax(ops_worlds, w):
    from multimodal_decoding_tpu.decoding.searchlight_engine import TestLayout
    from multimodal_decoding_tpu.parallel.distributed import sharded_searchlight_cv_step

    _, _, X_all, Y, idx = _ops_inputs()
    mesh = jax_vertex_mesh()
    step = sharded_searchlight_cv_step(mesh, TestLayout.from_stim_types(STIM_TYPES), N_TRAIN,
                                       N_TEST, ALPHAS, cv_solver="schur-pallas", cv_dtype=None)
    ref = step(jnp.asarray(X_all), *(jnp.asarray(y) for y in Y),
               jax.device_put(idx, NamedSharding(mesh, PartitionSpec("v", None))))
    for out in ops_worlds[w]:
        assert sorted(out["cv"]) == sorted(ref)
        np.testing.assert_array_equal(out["cv"]["best_alpha"], np.asarray(ref["best_alpha"]))
        for m, v in ref.items():
            np.testing.assert_allclose(out["cv"][m], np.asarray(v), rtol=0, atol=1e-4,
                                       err_msg=m)


# ---------------------------------------------------------------------------
# The vertex-sharded runner: CV + nulls, a killed run and its resume
# ---------------------------------------------------------------------------


def _runner_problem():
    from multimodal_decoding_tpu_torch.io.surface import knn_adjacency

    coords = icosphere(subdivisions=3, radius=50.0).coordinates
    rng = np.random.RandomState(1)
    coords = (coords + 0.5 * rng.randn(*coords.shape)).astype(np.float32)  # no kNN ties
    adjacency, _ = knn_adjacency(coords, RUN_K)
    Y = [rng.randn(n, D).astype(np.float32) for n in (N_TRAIN, N_TEST, N_IMAG)]
    W = rng.randn(D, len(coords)).astype(np.float32) * 0.4
    X = np.concatenate(Y) @ W + rng.randn(N_TRAIN + N_TEST + N_IMAG, len(coords)).astype(
        np.float32)
    shuffles = np.stack([np.concatenate([rng.permutation(5), 5 + rng.permutation(5)])
                         for _ in range(RUN_P)]).astype(np.int32)
    X_splits = [X[:N_TRAIN], X[N_TRAIN:N_TRAIN + N_TEST], X[N_TRAIN + N_TEST:]]
    return (*X_splits, *Y, adjacency, STIM_TYPES), shuffles


def _run_port(mesh=None, checkpoint_path=None):
    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

    args, shuffles = _runner_problem()
    return run_searchlight(*args, alphas_cv=ALPHAS, shuffles=shuffles, block_size=RUN_BLOCK,
                           mesh=mesh, device="cpu", cv_solver="schur-cb", progress=False,
                           checkpoint_path=checkpoint_path, checkpoint_every=CKPT_EVERY)


def _runner_rank(ckpt):
    """A run killed at the same block on every rank, then its resume."""
    import torch.distributed as dist

    from multimodal_decoding_tpu_torch.parallel import searchlight_runner as runner
    from multimodal_decoding_tpu_torch.parallel.mesh import vertex_mesh

    mesh = vertex_mesh("cpu")
    real_block, calls = runner.searchlight_block_cv_with_null, []

    def dying_block(*a, **k):
        calls.append(1)
        if len(calls) == DIE_AT_CALL:
            raise RuntimeError("injected mid-run failure")
        return real_block(*a, **k)

    runner.searchlight_block_cv_with_null = dying_block
    try:
        _run_port(mesh, ckpt)
        died = False
    except RuntimeError as e:
        died = "injected" in str(e)
    finally:
        runner.searchlight_block_cv_with_null = real_block
    dist.barrier()  # rank 0 wrote the checkpoint before it raised
    had_ckpt = os.path.isfile(ckpt)
    scores, aux = _run_port(mesh, ckpt)
    dist.barrier()
    return {"died": died, "had_ckpt": had_ckpt, "left_ckpt": os.path.isfile(ckpt),
            "scores": scores, "aux": aux}


@pytest.fixture(scope="module")
def runner_world(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("runner") / "sl.ckpt.npz")
    return spawn_world(_runner_rank, 2, args=(ckpt,), timeout_s=WORLD_TIMEOUT_S)


def _assert_runner_close(got, got_aux, ref, ref_aux):
    np.testing.assert_array_equal(got_aux["best_alpha"], np.asarray(ref_aux["best_alpha"]))
    assert sorted(got) == sorted(ref)
    for m, v in ref.items():
        np.testing.assert_allclose(got[m], v, rtol=2e-5, atol=2e-6, err_msg=m)
    for m, v in ref_aux["null_scores"].items():
        assert got_aux["null_scores"][m].shape == (642, RUN_P)
        np.testing.assert_array_equal(got_aux["null_scores"][m], v, err_msg=m)


def test_killed_and_resumed_two_rank_run_matches_one_device(runner_world):
    ref, ref_aux = _run_port()
    for out in runner_world:
        assert out["died"] and out["had_ckpt"] and not out["left_ckpt"]
        assert out["aux"]["resumed_at_block"] == 4  # the checkpoint after block 4 of 11
        assert out["aux"]["n_blocks"] == 11 and out["aux"]["block_size"] == RUN_BLOCK
        _assert_runner_close(out["scores"], out["aux"], ref, ref_aux)


def test_two_rank_run_matches_the_jax_runner(runner_world):
    from multimodal_decoding_tpu.parallel.searchlight_runner import run_searchlight

    args, shuffles = _runner_problem()
    ref, ref_aux = run_searchlight(*args, alphas_cv=ALPHAS, shuffles=shuffles,
                                   block_size=RUN_BLOCK, mesh=jax_vertex_mesh(),
                                   cv_precision=jax.lax.Precision.DEFAULT,
                                   cv_solver="schur-cb", progress=False)
    for out in runner_world:
        _assert_runner_close(out["scores"], out["aux"], ref, ref_aux)


def test_runner_refuses_a_block_that_does_not_split_over_the_world():
    from types import SimpleNamespace

    from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
        _auto_block_size,
        run_searchlight,
    )

    args, _ = _runner_problem()
    mesh = SimpleNamespace(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the 3-rank world"):
        run_searchlight(*args, alphas_cv=ALPHAS, block_size=RUN_BLOCK, mesh=mesh)
    assert _auto_block_size(8335, 750, 3) % 3 == 0


# ---------------------------------------------------------------------------
# The permutation-sharded group null
# ---------------------------------------------------------------------------


SUBJECTS = ["sub-01", "sub-02", "sub-03"]  # 2 ranks: an uneven 2/1 subject split


@pytest.fixture(scope="module")
def null_artifacts(tmp_path_factory):
    """JAX searchlight outputs (3 subjects x 3 modes, left hemisphere, 6 nulls
    each) and the JAX package's one-process permutation run on them."""
    from multimodal_decoding_tpu import config
    from multimodal_decoding_tpu.data.features import _load_feature_pickle
    from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu.decoding import permutation as JP
    from multimodal_decoding_tpu.decoding.searchlight import SearchlightConfig, run
    from multimodal_decoding_tpu.io.surface import edge_lengths

    tmp = tmp_path_factory.mktemp("null_mesh")
    mesh = icosphere(subdivisions=1, radius=50.0)
    for i, subj in enumerate(SUBJECTS):
        make_synthetic_dataset(str(tmp), subject=subj, n_train=24, n_vertices=mesh.n_vertices,
                               latent_dim=6, beta_seed=100 + i, n_nan_vertices=2)
    keys = ("FMRI_STIM_INFO_DIR", "LATENT_FEATURES_DIR", "BETAS_CACHE_DIR")
    orig = [getattr(config, k) for k in keys]
    for k, v in zip(keys, ("stim_info", "nn_features", "cache")):
        setattr(config, k, str(tmp / v))
    _load_feature_pickle.cache_clear()
    sl_out = str(tmp / "searchlight")
    try:
        for mode in ["agnostic", "images", "captions"]:
            run(SearchlightConfig(
                betas_dir=os.path.join(str(tmp), "betas", "surface"),
                mesh_coords={"left": mesh.coordinates}, model="clip", subjects=SUBJECTS,
                training_modes=[mode], hemis=["left"], n_neighbors=K, create_null_distr=True,
                n_permutations_per_subject=6, out_dir=sl_out, progress=False, block_size=8))
    finally:
        for k, v in zip(keys, orig):
            setattr(config, k, v)
        _load_feature_pickle.cache_clear()
    spec = dict(subjects=SUBJECTS, model="clip", mod_specific_images_model="clip",
                mod_specific_captions_model="clip", n_neighbors=K, n_permutations_group_level=12,
                p_value_threshold=0.1, edges_by_hemi={"left": edge_lengths(mesh)},
                hemis=["left"], searchlight_out_dir=sl_out, null_chunk=5)
    ref = JP.run(JP.PermutationConfig(out_dir=str(tmp / "jax_perm"), **spec))
    return spec, str(tmp / "port_perm"), ref


def _permutation_rank(spec, out_dir):
    """permutation.run on a "v" mesh; ranks other than 0 count their writes."""
    from multimodal_decoding_tpu_torch.decoding import permutation as TP
    from multimodal_decoding_tpu_torch.parallel.mesh import vertex_mesh

    mesh = vertex_mesh("cpu")
    writes = []
    if mesh.rank:
        def record(name):
            return lambda *a, **k: writes.append(name)

        TP.artifacts.save_pickle = record("save_pickle")
        TP.export_to_gifti = record("export_to_gifti")
        np.savez = record("np.savez")
        np.savez_compressed = record("np.savez_compressed")
    res = TP.run(TP.PermutationConfig(out_dir=out_dir, device="cpu", **spec), mesh=mesh)
    return {"writes": writes, "null_max_sorted": res["null_max_sorted"],
            "p_values": res["p_values"], "masks": res["masks"]}


def test_permutation_sharded_null_matches_jax_and_only_rank_0_writes(null_artifacts):
    from multimodal_decoding_tpu.decoding import permutation as JP

    spec, out_dir, ref = null_artifacts
    outs = spawn_world(_permutation_rank, 2, args=(spec, out_dir), timeout_s=WORLD_TIMEOUT_S)
    assert outs[1]["writes"] == []
    for out in outs:
        np.testing.assert_allclose(out["null_max_sorted"], ref["null_max_sorted"], rtol=1e-5)
        np.testing.assert_array_equal(out["p_values"]["left"], ref["p_values"]["left"])
        np.testing.assert_array_equal(out["masks"]["left"], ref["masks"]["left"])
    jcfg = JP.PermutationConfig(out_dir=out_dir, **spec)
    cached = np.load(os.path.join(JP.permutation_results_dir(jcfg),
                                  f"null_max{JP.get_hparam_suffix(jcfg)}.npz"))["null_max"]
    np.testing.assert_allclose(np.sort(cached), ref["null_max_sorted"], rtol=1e-5)
