"""Port parity in radius mode: masked neighbourhoods against column drop and
against the JAX package.

Radius mode pads every neighbourhood to the largest count and masks the pad
slots out of the fit: ``gather_patches`` zeroes their columns, so their gram
rows and columns vanish and the regulariser pins their weights to 0.  The
tests hold

* a masked block to the same vertices with the masked columns dropped
  (sklearn's Ridge per vertex, the JAX package's
  ``tests/test_searchlight.py::test_radius_mask_equals_column_drop``), and a
  masked CV+null block to the port's own column-drop blocks, one per count;
* a masked CV+null block to the JAX function on the same seeded inputs,
  under each null-gather formulation of the port;
* a radius-mode ``run()`` of both packages on one synthetic subject: the
  results path, the pickle's keys, ``n_neighbors`` (int32 in both),
  ``distances=None``, the selected alphas, scores within 1e-4 and the nulls;
* the adjacency cache, which both packages read and write.

Equality of alphas and nulls is meaningful only on tie-free inputs:
``MASK_SEED`` is the seed in 0..1599 whose masked problem clears the
engine tests' 1e-4 margin by the most (1.76e-4, ``tie_margin`` on the
masked problem), with every alpha of the grid selected.
"""

import os

import jax
import numpy as np
import pytest

from multimodal_decoding_tpu.decoding import searchlight as JS
from multimodal_decoding_tpu.decoding import searchlight_engine as JE
from multimodal_decoding_tpu_torch.decoding import searchlight as TS
from multimodal_decoding_tpu_torch.decoding import searchlight_engine as TE
from multimodal_decoding_tpu_torch.interop import block_inputs_from_numpy, to_numpy
from multimodal_decoding_tpu_torch.ops import metrics as M
from tests.test_searchlight import make_problem, ref_vertex_scores
from tests.test_torch_searchlight import _jittered_icosphere, _near_tie_null_entries
from tests.test_torch_searchlight_engine import (
    FIXED_ALPHA, N_TEST, N_TRAIN, STIM_TYPES, TIE_MARGIN, B, K, V, _assert_equal_dicts,
    make_block_problem, tie_margin,
)

MASK_SEED = 906
# vertex b has 3 + b % 4 real neighbours of K = 6; the pad slots repeat the
# first neighbour, as radius_adjacency pads them
COUNTS = 3 + np.arange(B) % (K - 2)
SCORE_TOL = 1e-4
COMMON = dict(n_train=N_TRAIN, n_test=N_TEST)


def _masked_problem() -> dict:
    p = make_block_problem(MASK_SEED)
    mask = np.arange(K)[None, :] < COUNTS[:, None]
    p["mask"] = mask
    p["idx"] = np.where(mask, p["idx"], p["idx"][:, :1]).astype(np.int32)
    return p


@pytest.fixture(scope="module")
def masked():
    p = _masked_problem()
    # the masked problem in float64: a zero column V stands in for every pad slot
    zero = dict(p, X_all=np.concatenate([p["X_all"], np.zeros((len(p["X_all"]), 1),
                                                                np.float32)], axis=1),
                idx=np.where(p["mask"], p["idx"], V))
    margin, selected = tie_margin(zero, N_TRAIN, N_TEST, STIM_TYPES, FIXED_ALPHA)
    assert margin > TIE_MARGIN, f"seed {MASK_SEED}: masked inputs not tie-free ({margin:.2e})"
    assert len(np.unique(selected)) == 3
    p["selected_f64"] = selected
    return p


def _torch(p):
    keys = ("X_all", "Y_train", "Y_test", "Y_imag", "idx", "mask", "alphas", "shuffles",
            "derangements")
    return block_inputs_from_numpy(device="cpu", **{k: p[k] for k in keys})


def test_radius_mask_equals_column_drop(rng):
    """Zero-masked neighbour columns == dropping those features from the fit."""
    Xtr, Xte, Xim, Ytr, Yte, Yim, stim_types, adj = make_problem(rng, k=6)
    X_all = np.concatenate([Xtr, Xte, Xim])
    mask = np.ones_like(adj, dtype=bool)
    mask[:, 4:] = False  # only the first 4 neighbours are real
    t = block_inputs_from_numpy(device="cpu", X_all=X_all, Y_train=Ytr, Y_test=Yte,
                                Y_imag=Yim, idx=adj, mask=mask)
    scores = to_numpy(TE.searchlight_block(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], t["mask"], 5.0,
        layout=TE.TestLayout.from_stim_types(stim_types), n_train=len(Xtr), n_test=len(Xte)))
    for v in [0, 7, 20]:
        ref, _, _ = ref_vertex_scores(Xtr, Xte, Xim, Ytr, Yte, Yim, stim_types, adj[v][:4], 5.0)
        for metric, val in ref.items():
            assert abs(float(scores[metric][v]) - val) < SCORE_TOL, (metric, v)


@pytest.mark.parametrize("cv_solver", ["schur-cb", "schur-pallas", None])
def test_masked_cv_block_equals_column_drop(masked, cv_solver):
    """The CV+null block step on padded, masked neighbourhoods against the
    same step on each count's vertices with the pad columns dropped: alphas
    and nulls equal, scores within 1e-4."""
    p, t = masked, _torch(masked)
    layout = TE.TestLayout.from_stim_types(STIM_TYPES)
    kw = dict(layout=layout, cv_solver=cv_solver, **COMMON)
    main, null = to_numpy(TE.searchlight_block_cv_with_null(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], t["mask"], t["alphas"],
        t["shuffles"], t["derangements"], **kw))
    np.testing.assert_array_equal(main["best_alpha"], p["selected_f64"])
    for count in np.unique(COUNTS):
        rows = np.where(COUNTS == count)[0]
        ref_main, ref_null = to_numpy(TE.searchlight_block_cv_with_null(
            t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"][rows, :count], None,
            t["alphas"], t["shuffles"], t["derangements"][rows], **kw))
        np.testing.assert_array_equal(main["best_alpha"][rows], ref_main["best_alpha"])
        for m, v in ref_main.items():
            np.testing.assert_allclose(main[m][rows], v, rtol=0, atol=SCORE_TOL, err_msg=m)
        for m, v in ref_null.items():
            np.testing.assert_array_equal(null[m][rows], v, err_msg=m)


@pytest.mark.parametrize("null_gather", ["gather", "onehot", "onehot-bf16"])
def test_masked_cv_with_null_block_matches_jax(masked, null_gather):
    """The main path's block step on masked neighbourhoods in both packages
    (the JAX one with the Pallas panel kernel in interpret mode): scores,
    alphas and nulls equal, under each of the port's null gathers."""
    p, t = masked, _torch(masked)
    ref = JE.searchlight_block_cv_with_null(
        p["X_all"], p["Y_train"], p["Y_test"], p["Y_imag"], p["idx"], p["mask"], p["alphas"],
        p["shuffles"], p["derangements"], layout=JE.TestLayout.from_stim_types(STIM_TYPES),
        cv_solver="schur-pallas", cv_precision=jax.lax.Precision.DEFAULT, **COMMON)
    got = TE.searchlight_block_cv_with_null(
        t["X_all"], t["Y_train"], t["Y_test"], t["Y_imag"], t["idx"], t["mask"], t["alphas"],
        t["shuffles"], t["derangements"], layout=TE.TestLayout.from_stim_types(STIM_TYPES),
        cv_solver="schur-pallas", null_gather=null_gather, **COMMON)
    for r, g in zip(ref, to_numpy(got)):
        _assert_equal_dicts(r, g)
    np.testing.assert_array_equal(to_numpy(got[0])["best_alpha"], p["selected_f64"])


@pytest.mark.parametrize("n_rows,kmax", [(8335, 797), (8335, 800), (40, 11)])
def test_block_sizing_at_kmax_matches_jax(n_rows, kmax):
    """The runner's auto block size divides its budget by the padded width."""
    from multimodal_decoding_tpu.parallel import searchlight_runner as JR
    from multimodal_decoding_tpu_torch.parallel import searchlight_runner as TR

    assert TR._auto_block_size(n_rows, kmax) == JR._auto_block_size(n_rows, kmax, 1)


RADIUS = 28.0  # on icosphere(2) of radius 50: 7 to 13 neighbours, ~10 on average
N_PERMS = 6


@pytest.fixture()
def dataset(tmp_path, monkeypatch):
    from multimodal_decoding_tpu import config as jax_config
    from multimodal_decoding_tpu.data.features import _load_feature_pickle as jax_cache
    from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch import config as torch_config
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle as torch_cache

    mesh = _jittered_icosphere(2, 50.0)
    info = make_synthetic_dataset(str(tmp_path), n_train=40, n_vertices=mesh.n_vertices,
                                  latent_dim=6, hemis=["left"])
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "FMRI_STIM_INFO_DIR", info["stim_info_dir"])
        monkeypatch.setattr(cfg, "LATENT_FEATURES_DIR", info["features_dir"])
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "cache"))
    jax_cache.cache_clear()
    torch_cache.cache_clear()
    info["coords"] = mesh.coordinates
    return info


def _run(pkg, dataset, out_dir, **kw):
    cfg = pkg.SearchlightConfig(
        betas_dir=os.path.join(dataset["betas_dir"], "surface"),
        mesh_coords={"left": dataset["coords"]}, model=dataset["model"],
        subjects=["sub-01"], hemis=["left"], radius=RADIUS, alphas_cv=[0.1, 10.0, 1000.0],
        create_null_distr=True, n_permutations_per_subject=N_PERMS, block_size=8,
        out_dir=out_dir, progress=False, **kw)
    (path,) = pkg.run(cfg)
    return path


def test_radius_run_matches_jax(dataset, tmp_path):
    from multimodal_decoding_tpu.io import artifacts as JA
    from multimodal_decoding_tpu_torch.io import artifacts as TA

    jax_out, torch_out = str(tmp_path / "jax_sl"), str(tmp_path / "torch_sl")
    jax_path = _run(JS, dataset, jax_out)
    torch_path = _run(TS, dataset, torch_out, device="cpu")
    rel = os.path.relpath(torch_path, torch_out)
    assert rel == os.path.relpath(jax_path, jax_out)
    assert f"{os.sep}radius_{RADIUS}{os.sep}" in rel

    res_j, res_t = TA.load_pickle(jax_path), JA.load_pickle(torch_path)
    assert sorted(res_t) == sorted(res_j)
    assert res_t["distances"] is None and res_j["distances"] is None
    counts = res_j["n_neighbors"]
    assert res_t["n_neighbors"].dtype == counts.dtype == np.int32
    np.testing.assert_array_equal(res_t["n_neighbors"], counts)
    assert counts.min() < counts.max() == res_j["adjacency"].shape[1]  # padded and masked
    np.testing.assert_array_equal(res_t["adjacency"], res_j["adjacency"])
    np.testing.assert_array_equal(res_t["nan_locations"], res_j["nan_locations"])
    np.testing.assert_array_equal(res_t["best_alpha"], res_j["best_alpha"])
    assert sorted(res_t["score_maps"]) == sorted(res_j["score_maps"])
    for m, v in res_j["score_maps"].items():
        np.testing.assert_allclose(res_t["score_maps"][m], v, rtol=0, atol=SCORE_TOL,
                                   err_msg=m)
    assert res_t["scores"][0].keys() == res_j["scores"][0].keys()
    assert np.mean(res_t["score_maps"][M.ACC_CAPTIONS]) > 0.9  # planted signal

    null_path = os.path.join(os.path.dirname(jax_path), "null_distr.npz")
    null_j = TA.load_null_scores_npz(null_path)
    null_t = JA.load_null_scores_npz(os.path.join(os.path.dirname(torch_path),
                                                  "null_distr.npz"))
    assert sorted(null_t) == sorted(null_j)
    # a vertex's real neighbours are its first n_neighbors slots
    real = dict(res_j, adjacency=[a[:c] for a, c in zip(res_j["adjacency"], counts)])
    near_tie = _near_tie_null_entries(dataset, real)
    for m, v in null_j.items():
        assert null_t[m].shape == v.shape == (len(counts), N_PERMS), m
        clear = ~near_tie[m] if m in near_tie else np.ones(v.shape, dtype=bool)
        assert clear.mean() > 0.5, (m, clear.mean())
        np.testing.assert_array_equal(null_t[m][clear], v[clear], err_msg=m)


def test_radius_adjacency_cache_is_shared(tmp_path):
    """Each package reads the radius adjacency the other cached, dtypes and all."""
    coords = _jittered_icosphere(2, 50.0).coordinates
    nan = np.zeros(len(coords), dtype=bool)
    nan[[3, 40]] = True
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    t_built = TS.build_adjacency(coords, nan, radius=RADIUS, cache_dir=t_dir, device="cpu")
    j_built = JS.build_adjacency(coords, nan, radius=RADIUS, cache_dir=j_dir)
    assert os.listdir(t_dir) == os.listdir(j_dir)
    j_read = JS.build_adjacency(coords, nan, radius=RADIUS, cache_dir=t_dir)
    t_read = TS.build_adjacency(coords, nan, radius=RADIUS, cache_dir=j_dir, device="cpu")
    for got in (t_built, j_read, t_read):
        assert got[3] is None
        for a, b in zip(got[:3], j_built[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
