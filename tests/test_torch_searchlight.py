"""Port parity end to end: both searchlight CLIs, both runners, the artifacts.

The JAX CLI and the port's CLI (``--device cpu``) run on one synthetic
subject (icosphere mesh, the route of .claude/skills/verify/SKILL.md) with
per-vertex alpha CV and null distributions.  Score maps, selected alphas and
null scores must be equal (the imagery derangements are the same
``jax.random`` draws in both packages).  Fed the same derangements, the two
runners agree on every null score.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu.io import artifacts as jax_artifacts
from multimodal_decoding_tpu.io.surface import icosphere, write_freesurfer_geometry
from multimodal_decoding_tpu.parallel.mesh import vertex_mesh
from multimodal_decoding_tpu.parallel.searchlight_runner import (
    run_searchlight as jax_run_searchlight,
)
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch.decoding import searchlight as TS
from multimodal_decoding_tpu_torch.io import artifacts as torch_artifacts
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
    draw_imagery_derangements,
    run_searchlight as torch_run_searchlight,
)
from tests.test_torch_searchlight_engine import (
    ALPHAS, N_TEST, N_TRAIN, P, SEED, STIM_TYPES, make_block_problem,
)

# null scores read from caption/image rank counts, where float32 near-ties may move
# an entry by a count
NULL_RANK_COUNTS = (M.ACC_CAPTIONS, M.ACC_IMAGES)
N_PERMS = 6


def _jittered_icosphere(subdivisions, radius, seed=0):
    """An icosphere with its exact distance ties broken: the two packages'
    exact kNN (sklearn's KD-tree there, scipy's here) may choose differently
    among exactly equidistant neighbours."""
    mesh = icosphere(subdivisions=subdivisions, radius=radius)
    rng = np.random.RandomState(seed)
    mesh.coordinates = (mesh.coordinates
                        + 0.01 * radius * rng.randn(*mesh.coordinates.shape)).astype(np.float32)
    return mesh


def test_adjacency_matches_jax():
    from multimodal_decoding_tpu.io import surface as JSurf
    from multimodal_decoding_tpu_torch.io import surface as TSurf

    coords = _jittered_icosphere(2, 100.0).coordinates
    ji, jd = JSurf.knn_adjacency(coords, 20)
    ti, td = TSurf.knn_adjacency(coords, 20)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    di, dd = TSurf.knn_adjacency(coords, 20, method="device", device="cpu", block=50)
    np.testing.assert_array_equal(di, ji)
    # float32 |q|^2 - 2 q.p + |p|^2 at |p| ~ 100 cancels to ~0.05 absolute
    np.testing.assert_allclose(dd, jd, rtol=0, atol=0.1)
    ri, rm, rc = JSurf.radius_adjacency(coords, 30.0)
    ti, tm, tc = TSurf.radius_adjacency(coords, 30.0, device="cpu", block=50)
    np.testing.assert_array_equal(tc, rc)
    np.testing.assert_array_equal(tm, rm)
    np.testing.assert_array_equal(np.where(tm, ti, -1), np.where(rm, ri, -1))


@pytest.fixture()
def dataset(tmp_path, monkeypatch):
    mesh = _jittered_icosphere(1, 50.0)
    info = make_synthetic_dataset(str(tmp_path), n_train=40, n_vertices=mesh.n_vertices,
                                  latent_dim=6, hemis=["left"])
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "FMRI_STIM_INFO_DIR", info["stim_info_dir"])
        monkeypatch.setattr(cfg, "LATENT_FEATURES_DIR", info["features_dir"])
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "cache"))
    from multimodal_decoding_tpu.data.features import _load_feature_pickle as jax_cache
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle as torch_cache

    jax_cache.cache_clear()
    torch_cache.cache_clear()
    mesh_dir = tmp_path / "surfaces" / "fsaverage7"
    os.makedirs(mesh_dir)
    write_freesurfer_geometry(str(mesh_dir / "lh.inflated"), mesh)
    info["mesh_dir"] = str(tmp_path / "surfaces")
    return info


def _cli_args(dataset, out_dir):
    return ["--betas-dir", os.path.join(dataset["betas_dir"], "surface"),
            "--subjects", "sub-01", "--model", dataset["model"],
            "--n-neighbors", "5", "--hemis", "left",
            "--l2-alphas", "0.1", "10", "1000",
            "--create-null-distr", "--n-permutations-per-subject", str(N_PERMS),
            "--mesh-dir", dataset["mesh_dir"], "--out-dir", out_dir, "--block-size", "8"]


def _results(out_dir):
    found = [os.path.join(root, f) for root, _, files in os.walk(out_dir)
             for f in files if f.startswith("alpha_") and f.endswith(".p")]
    assert len(found) == 1, found
    return found[0], os.path.join(os.path.dirname(found[0]), "null_distr.npz")


def test_both_clis_agree_and_read_each_other(dataset, tmp_path, monkeypatch):
    from multimodal_decoding_tpu.cli.run_searchlight import main as jax_main
    from multimodal_decoding_tpu_torch.cli.run_searchlight import main as torch_main

    jax_out, torch_out = str(tmp_path / "jax_sl"), str(tmp_path / "torch_sl")
    monkeypatch.setattr(sys, "argv", ["prog", *_cli_args(dataset, jax_out)])
    jax_main()
    torch_main(_cli_args(dataset, torch_out) + ["--device", "cpu"])

    jax_pickle, jax_null = _results(jax_out)
    torch_pickle, torch_null = _results(torch_out)
    # same path contract under each out dir
    assert os.path.relpath(jax_pickle, jax_out) == os.path.relpath(torch_pickle, torch_out)

    # each package reads the other's artifacts with its own readers
    res_j = torch_artifacts.load_pickle(jax_pickle)
    res_t = jax_artifacts.load_pickle(torch_pickle)
    null_j = torch_artifacts.load_null_scores_npz(jax_null)
    null_t = jax_artifacts.load_null_scores_npz(torch_null)
    assert set(res_j) == set(res_t)

    np.testing.assert_array_equal(res_t["nan_locations"], res_j["nan_locations"])
    np.testing.assert_array_equal(res_t["adjacency"], res_j["adjacency"])
    np.testing.assert_array_equal(res_t["best_alpha"], res_j["best_alpha"])
    assert sorted(res_t["score_maps"]) == sorted(res_j["score_maps"])
    for m, v in res_j["score_maps"].items():
        np.testing.assert_array_equal(res_t["score_maps"][m], v, err_msg=m)
    assert len(res_t["scores"]) == len(res_j["scores"])
    assert res_t["scores"][0].keys() == res_j["scores"][0].keys()

    assert sorted(null_t) == sorted(null_j)
    n_vert = int((~res_j["nan_locations"]).sum())
    near_tie = _near_tie_null_entries(dataset, res_j)
    one_count = 1.0 / (70 * 70 - 70)
    for m, v in null_j.items():
        assert null_t[m].shape == v.shape == (n_vert, N_PERMS), m
        if m in NULL_RANK_COUNTS:
            # equal wherever none of the rank comparisons behind the entry is
            # a float64 near-tie (< 1e-5); there float32 rounding may move
            # the score by a count
            clear = ~near_tie[m]
            assert clear.mean() > 0.5, clear.mean()
            np.testing.assert_array_equal(null_t[m][clear], v[clear], err_msg=m)
            assert np.abs(null_t[m] - v).max() <= 2 * one_count + 1e-7, m
        else:
            np.testing.assert_array_equal(null_t[m], v, err_msg=m)
    assert np.mean(res_t["score_maps"][M.ACC_CAPTIONS]) > 0.9  # planted signal


def _near_tie_null_entries(dataset, res, gap=1e-5):
    """{metric: [V, P] bool}: null entries that pick a rank count decided by a
    float64 near-tie.

    Recomputes, from the inputs the CLIs read and at each vertex's selected
    alpha, every caption/image distance in float64.  Row i of the rank
    counts holds a near-tie between columns c and c' when their distances
    differ by less than ``gap``; shuffle p's null score reads C[i, perm_p(i)]
    and so depends on that tie when perm_p(i) is c or c'.
    """
    from multimodal_decoding_tpu_torch.config import LatentFeatsConfig
    from multimodal_decoding_tpu_torch.data.betas import get_fmri_surface_data
    from multimodal_decoding_tpu_torch.data.features import get_latent_features
    from multimodal_decoding_tpu_torch.data.preprocess import (
        standardize_fmri_betas, standardize_latents,
    )
    from multimodal_decoding_tpu_torch.data.stimuli import (
        TEST_STIM_TYPES, create_null_distr_shuffled_indices,
    )
    from tests.test_torch_searchlight_engine import _cos, _std

    betas_dir = os.path.join(dataset["betas_dir"], "surface")
    splits = [get_fmri_surface_data(betas_dir, "sub-01", s, hemi="left")[0]
              for s in ("train", "test", "imagery")]
    Xtr, Xte, _ = (x.astype(np.float64) for x in standardize_fmri_betas(*splits))
    feats = LatentFeatsConfig(dataset["model"], verbose=False)
    lats = [get_latent_features(feats, "sub-01", s) for s in ("train", "test", "imagery")]
    Ytr, Yte, _ = (y.astype(np.float64) for y in standardize_latents(*lats))
    shuffles = np.stack(create_null_distr_shuffled_indices(N_PERMS))
    out = {}
    for name, kind in ((M.ACC_CAPTIONS, "caption"), (M.ACC_IMAGES, "image")):
        sel = np.where(TEST_STIM_TYPES == kind)[0]
        inv = np.zeros(len(TEST_STIM_TYPES), dtype=int)
        inv[sel] = np.arange(len(sel))
        local = inv[shuffles[:, sel]]  # [P, n]
        rows = np.arange(len(sel))
        flags = []
        for nbrs, alpha in zip(res["adjacency"], res["best_alpha"]):
            A = Xtr[:, nbrs]
            W = np.linalg.solve(A.T @ A + alpha * np.eye(len(nbrs)), A.T @ Ytr)
            d = 1.0 - _cos(_std(Xte[sel][:, nbrs] @ W), Yte[sel])  # [n, n]
            g = np.abs(d[:, :, None] - d[:, None, :])
            g[:, rows, rows] = np.inf
            tied = (g < gap).any(axis=-1)  # [n, n]: row i, column c
            flags.append(tied[rows[None, :], local].any(axis=-1))  # [P]
        out[name] = np.array(flags)
    return out


def _jax_derangements(null_seed, n_blocks, block_size, n_perms):
    """The JAX runner's per-block jax.random draws, stacked [n_blocks*B, P]."""
    rng = jax.random.PRNGKey(null_seed)
    return np.concatenate([
        np.asarray(jax.random.randint(jax.random.fold_in(rng, b), (block_size, n_perms),
                                      0, 2, dtype=jnp.int32))
        for b in range(n_blocks)
    ])


def _runner_problem():
    p = make_block_problem(SEED)  # tie-free inputs (see test_torch_searchlight_engine)
    X = p["X_all"]
    return dict(X_train=X[:N_TRAIN], X_test=X[N_TRAIN:N_TRAIN + N_TEST],
                X_imag=X[N_TRAIN + N_TEST:], Y_train=p["Y_train"], Y_test=p["Y_test"],
                Y_imag=p["Y_imag"], adjacency=p["idx"], stim_types_test=STIM_TYPES), p


def test_runners_agree_with_shared_derangements():
    prob, p = _runner_problem()
    common = dict(alphas_cv=ALPHAS, shuffles=p["shuffles"], block_size=8, progress=False,
                  cv_solver="schur-cb")
    ref, ref_aux = jax_run_searchlight(**prob, mesh=vertex_mesh(jax.devices()[:1]),
                                       cv_precision=jax.lax.Precision.DEFAULT, **common)
    der = _jax_derangements(0, 2, 8, P)
    got, aux = torch_run_searchlight(**prob, device="cpu", imagery_derangements=der, **common)
    assert sorted(got) == sorted(ref)
    for m in ref:
        np.testing.assert_array_equal(got[m], ref[m], err_msg=m)
    np.testing.assert_array_equal(aux["best_alpha"], ref_aux["best_alpha"])
    for m, v in ref_aux["null_scores"].items():
        np.testing.assert_array_equal(aux["null_scores"][m], v, err_msg=m)
    assert aux["n_blocks"] == ref_aux["n_blocks"] == 2

    # the port's own draw is the JAX runner's jax.random stream
    again, again_aux = torch_run_searchlight(**prob, device="cpu", **common)
    drawn = np.concatenate([draw_imagery_derangements(0, b, 8, P) for b in range(2)])
    np.testing.assert_array_equal(drawn, der)
    explicit, explicit_aux = torch_run_searchlight(**prob, device="cpu",
                                                   imagery_derangements=drawn, **common)
    for m, v in again_aux["null_scores"].items():
        np.testing.assert_array_equal(explicit_aux["null_scores"][m], v, err_msg=m)
    np.testing.assert_array_equal(draw_imagery_derangements(3, 1, 8, P),
                                  _jax_derangements(3, 2, 8, P)[8:])
    with pytest.raises(ValueError, match="imagery_derangements must be"):
        torch_run_searchlight(**prob, device="cpu", imagery_derangements=drawn[:8], **common)


@pytest.mark.parametrize("cv_scorer", ["pallas", "fused-pallas"])
def test_runners_agree_with_streamed_scorers(cv_scorer):
    """The streamed-count selection path end to end: the JAX runner with its
    Pallas count kernel (interpret mode) and the port's runner with the plain
    version agree on every score, null score and selected alpha."""
    prob, p = _runner_problem()
    common = dict(alphas_cv=ALPHAS, shuffles=p["shuffles"], block_size=8, progress=False,
                  cv_solver="schur-cb", cv_scorer=cv_scorer)
    ref, ref_aux = jax_run_searchlight(**prob, mesh=vertex_mesh(jax.devices()[:1]),
                                       cv_precision=jax.lax.Precision.HIGHEST, **common)
    got, aux = torch_run_searchlight(**prob, device="cpu",
                                     imagery_derangements=_jax_derangements(0, 2, 8, P),
                                     **common)
    assert sorted(got) == sorted(ref)
    for m in ref:
        np.testing.assert_array_equal(got[m], ref[m], err_msg=m)
    np.testing.assert_array_equal(aux["best_alpha"], ref_aux["best_alpha"])
    for m, v in ref_aux["null_scores"].items():
        np.testing.assert_array_equal(aux["null_scores"][m], v, err_msg=m)


@pytest.mark.parametrize("cv_scorer,kernel", [
    ("pallas", "streamed_pairwise_acc"),
    ("fused-pallas", "streamed_acc_from_factors"),
    ("fused-inv", "streamed_acc_from_inv"),
])
def test_runner_reaches_each_streamed_kernel(monkeypatch, cv_scorer, kernel):
    """run_searchlight(cv_scorer=...) calls the scorer's kernel wrapper once per
    (block, fold, alpha), and no other wrapper."""
    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    calls = dict.fromkeys(HM.KERNELS, 0)

    def spy(name):
        wrapped = getattr(HM, name)

        def call(*args):
            calls[name] += 1
            return wrapped(*args)
        return call

    for name in HM.KERNELS:
        monkeypatch.setattr(HM, name, spy(name))
    prob, p = _runner_problem()
    torch_run_searchlight(**prob, alphas_cv=ALPHAS, shuffles=p["shuffles"], block_size=8,
                          progress=False, cv_solver="schur-cb", cv_scorer=cv_scorer,
                          device="cpu")
    expected = dict.fromkeys(HM.KERNELS, 0)
    expected[kernel] = 2 * 5 * len(ALPHAS)  # blocks x folds x alphas
    assert calls == expected


def test_resume_false_deletes_stale_checkpoint(tmp_path):
    """resume=False (--overwrite) starts from scratch and deletes a stale
    checkpoint; resume=True resumes it and rates only the new work."""
    prob, _ = _runner_problem()
    prob["adjacency"] = np.concatenate([prob["adjacency"]] * 2)  # 32 vertices, 4 blocks
    kwargs = dict(alpha=2.0, block_size=8, progress=False, device="cpu")
    fresh, aux_fresh = torch_run_searchlight(**prob, **kwargs)
    assert "resumed_at_block" not in aux_fresh

    def fabricate_ckpt(path):
        poisoned = [{m: np.full(8, 99.0, np.float32) for m in fresh} for _ in range(2)]
        np.savez(path.removesuffix(".npz"), done_blocks=1,
                 results=np.array(poisoned, dtype=object),
                 null_results=np.array([], dtype=object))

    ckpt = str(tmp_path / "sl.ckpt.npz")
    fabricate_ckpt(ckpt)
    over, aux_over = torch_run_searchlight(**prob, checkpoint_path=ckpt, resume=False,
                                           checkpoint_every=0, **kwargs)
    assert not os.path.exists(ckpt)
    assert "resumed_at_block" not in aux_over
    for m in fresh:
        np.testing.assert_array_equal(over[m], fresh[m], err_msg=m)

    fabricate_ckpt(ckpt)
    res, aux_res = torch_run_searchlight(**prob, checkpoint_path=ckpt, resume=True, **kwargs)
    assert aux_res["resumed_at_block"] == 2
    key = next(iter(fresh))
    np.testing.assert_array_equal(res[key][:16], np.full(16, 99.0, np.float32))
    np.testing.assert_array_equal(res[key][16:], fresh[key][16:])
    assert np.isclose(aux_res["vertices_per_sec"] * aux_res["elapsed_s"], 16.0)
    assert not os.path.exists(ckpt)  # a finished run removes its checkpoint


def test_checkpoint_written_during_run_and_resumed(tmp_path):
    prob, p = _runner_problem()
    kwargs = dict(alphas_cv=ALPHAS, shuffles=p["shuffles"], block_size=8, progress=False,
                  device="cpu", cv_solver="schur-cb")
    ref, ref_aux = torch_run_searchlight(**prob, **kwargs)
    # a run over the first block only, saved as the checkpoint of a killed run
    part, part_aux = torch_run_searchlight(**{**prob, "adjacency": prob["adjacency"][:8]},
                                           **kwargs)
    ckpt = str(tmp_path / "run.ckpt.npz")
    np.savez(ckpt.removesuffix(".npz"), done_blocks=0,
             results=np.array([{**part, "best_alpha": part_aux["best_alpha"]}], dtype=object),
             null_results=np.array([part_aux["null_scores"]], dtype=object))
    res, aux = torch_run_searchlight(**prob, checkpoint_path=ckpt, **kwargs)
    assert aux["resumed_at_block"] == 1
    for m in ref:
        np.testing.assert_array_equal(res[m], ref[m], err_msg=m)
    for m in ref_aux["null_scores"]:
        np.testing.assert_array_equal(aux["null_scores"][m], ref_aux["null_scores"][m])


def test_unported_run_options_raise(dataset, tmp_path, monkeypatch):
    coords = {"left": _jittered_icosphere(1, 50.0).coordinates}
    base = dict(betas_dir=os.path.join(dataset["betas_dir"], "surface"), mesh_coords=coords,
                model=dataset["model"], subjects=["sub-01"], hemis=["left"], n_neighbors=5,
                out_dir=str(tmp_path / "o"), device="cpu")
    # streamed ingestion reads the betas npz cache, which no eager run has
    # written yet here
    with pytest.raises(FileNotFoundError, match="stream_ingest=on"):
        TS.run(TS.SearchlightConfig(**base, stream_ingest="on"))
    # fast math is ported: it runs (its parity is tests/test_torch_fast_math.py's)
    (path,) = TS.run(TS.SearchlightConfig(**base, fast_math=True, progress=False))
    assert os.path.isfile(path)
    monkeypatch.setenv("MMD_STREAM_INGEST", "sometimes")
    with pytest.raises(ValueError, match="stream_ingest"):
        TS.run(TS.SearchlightConfig(**base))
    assert TS.default_cv_solver("cpu") == "schur-cb"
    assert TS.default_cv_dtype() is None
    # the runner's null gather where none is named: the plain gather
    from multimodal_decoding_tpu_torch.parallel import searchlight_runner as TR

    gathers, step = [], TR.searchlight_block_with_null
    monkeypatch.setattr(TR, "searchlight_block_with_null",
                        lambda *a, **k: gathers.append(k["null_gather"]) or step(*a, **k))
    prob, p = _runner_problem()
    torch_run_searchlight(**prob, shuffles=p["shuffles"], block_size=8, device="cpu",
                          progress=False, null_gather=None)
    assert gathers and set(gathers) == {"gather"}


@pytest.mark.parametrize("n_rows,k,block,n_perms", [(8335, 750, 128, 100), (40, 5, 8, None),
                                                   (43, 6, 3, 1000)])
def test_runner_sizing_helpers_match_jax(n_rows, k, block, n_perms):
    from multimodal_decoding_tpu.parallel import searchlight_runner as JR
    from multimodal_decoding_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from multimodal_decoding_tpu_torch.parallel import searchlight_runner as TR

    assert TR._auto_block_size(n_rows, k) == JR._auto_block_size(n_rows, k, 1)
    assert TR._flush_cadence(block, n_perms) == JR._flush_cadence(block, n_perms)
    adj = np.arange(n_rows * 2).reshape(n_rows, 2).astype(np.int32)
    (got, n_got), (ref, n_ref) = TR.pad_to_multiple(adj, block), jax_pad(adj, block)
    np.testing.assert_array_equal(got, ref)
    assert n_got == n_ref == n_rows
