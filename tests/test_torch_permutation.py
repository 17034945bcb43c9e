"""Port parity: the group permutation pipeline against the JAX package's.

Both packages' ``run`` read one set of searchlight artifacts (the
``tests/test_permutation.py`` fixture: 3 synthetic subjects on icosphere(1),
both hemispheres, 6 null permutations per subject): t-values agree within
1e-5 with equal NaN patterns, TFCE values and ``null_max`` within rtol 1e-5
(the JAX package's own bar, tests/test_permutation.py:294-296), p-values,
masks and cluster tables exactly.  Each package then resumes from the
other's ``t_values.p`` and ``null_max*.npz`` and skips those stages.
"""

import dataclasses
import os

import numpy as np
import pytest

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu.decoding import permutation as JP
from multimodal_decoding_tpu.io.surface import edge_lengths, icosphere
from multimodal_decoding_tpu.ops import metrics as JM
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch.decoding import permutation as TP
from multimodal_decoding_tpu_torch.io.surface import write_freesurfer_geometry

SUBJECTS = ["sub-01", "sub-02", "sub-03"]
N_GROUP = 20


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """JAX searchlight outputs for 3 subjects x 3 modes x 2 hemis, with nulls."""
    tmp = tmp_path_factory.mktemp("perm_parity")
    mesh = icosphere(subdivisions=1, radius=50.0)  # 42 vertices
    for i, subj in enumerate(SUBJECTS):
        make_synthetic_dataset(str(tmp), subject=subj, n_train=40, n_vertices=mesh.n_vertices,
                               latent_dim=6, surface=True, beta_seed=100 + i,
                               n_nan_vertices=2)
    keys = ("FMRI_STIM_INFO_DIR", "LATENT_FEATURES_DIR", "BETAS_CACHE_DIR")
    orig = {cfg: [getattr(cfg, k) for k in keys] for cfg in (jax_config, torch_config)}
    for cfg in orig:
        for k, v in zip(keys, (tmp / "stim_info", tmp / "nn_features", tmp / "cache")):
            setattr(cfg, k, str(v))
    from multimodal_decoding_tpu.data.features import _load_feature_pickle

    _load_feature_pickle.cache_clear()
    from multimodal_decoding_tpu.decoding.searchlight import SearchlightConfig, run

    coords = {"left": mesh.coordinates, "right": mesh.coordinates}
    sl_out = str(tmp / "searchlight")
    for mode in ["agnostic", "images", "captions"]:
        run(SearchlightConfig(
            betas_dir=os.path.join(str(tmp), "betas", "surface"), mesh_coords=coords,
            model="clip", subjects=SUBJECTS, training_modes=[mode], n_neighbors=6,
            create_null_distr=True, n_permutations_per_subject=6, out_dir=sl_out,
            progress=False, block_size=8))
    mesh_dir = tmp / "surfaces" / "fsaverage7"
    os.makedirs(mesh_dir)
    for h in ("lh", "rh"):
        write_freesurfer_geometry(str(mesh_dir / f"{h}.inflated"), mesh)
    yield {"tmp": tmp, "mesh": mesh, "sl_out": sl_out, "mesh_dir": str(tmp / "surfaces")}
    for cfg, vals in orig.items():
        for k, v in zip(keys, vals):
            setattr(cfg, k, v)
    _load_feature_pickle.cache_clear()


def _config(module, artifacts, out_dir, **kw):
    edges, lens = edge_lengths(artifacts["mesh"])
    extra = {"device": "cpu"} if module is TP else {}
    return module.PermutationConfig(
        subjects=SUBJECTS, model="clip", mod_specific_images_model="clip",
        mod_specific_captions_model="clip", n_neighbors=6,
        n_permutations_group_level=N_GROUP, p_value_threshold=0.06,
        edges_by_hemi={"left": (edges, lens), "right": (edges, lens)},
        searchlight_out_dir=artifacts["sl_out"], out_dir=str(out_dir), null_chunk=8,
        **extra, **kw)


@pytest.fixture(scope="module")
def both_runs(artifacts):
    tmp = artifacts["tmp"]
    jcfg = _config(JP, artifacts, tmp / "jax_perm")
    tcfg = _config(TP, artifacts, tmp / "torch_perm")
    return JP.run(jcfg), jcfg, TP.run(tcfg), tcfg


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_t_close(got, ref):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_pipeline_matches_jax(both_runs):
    ref, jcfg, got, tcfg = both_runs
    assert _files(jcfg.out_dir) == _files(tcfg.out_dir)  # same artifacts, same paths
    for hemi in ("left", "right"):
        assert sorted(got["t_values"][hemi]) == sorted(ref["t_values"][hemi])
        for m, v in ref["t_values"][hemi].items():
            assert got["t_values"][hemi][m].dtype == np.float32
            _assert_t_close(got["t_values"][hemi][m], v)
        np.testing.assert_allclose(got["tfce_values"][hemi][jcfg.metric],
                                   ref["tfce_values"][hemi][jcfg.metric], rtol=1e-5)
        np.testing.assert_array_equal(got["p_values"][hemi], ref["p_values"][hemi])
        np.testing.assert_array_equal(got["masks"][hemi], ref["masks"][hemi])
    assert sum(got["masks"][h].sum() for h in ("left", "right")) > 0  # planted signal
    np.testing.assert_allclose(got["null_max_sorted"], ref["null_max_sorted"], rtol=1e-5)
    j_null = np.load(os.path.join(JP.permutation_results_dir(jcfg),
                                  f"null_max{JP.get_hparam_suffix(jcfg)}.npz"))["null_max"]
    t_null = np.load(os.path.join(TP.permutation_results_dir(tcfg),
                                  f"null_max{TP.get_hparam_suffix(tcfg)}.npz"))["null_max"]
    np.testing.assert_allclose(t_null, j_null, rtol=1e-5)  # permutation by permutation
    assert got["significance_cutoff"] == pytest.approx(ref["significance_cutoff"], rel=1e-5)
    assert [{k: c[k] for k in ("hemi", "id", "size", "peak_vertex")} for c in got["clusters"]] \
        == [{k: c[k] for k in ("hemi", "id", "size", "peak_vertex")} for c in ref["clusters"]]


def _prefill(src_cfg, dst_dir):
    """A fresh out dir holding only src's t_values.p and null_max npz."""
    src = JP.permutation_results_dir(src_cfg)
    suffix = JP.get_hparam_suffix(src_cfg)
    dst = JP.permutation_results_dir(dataclasses.replace(src_cfg, out_dir=str(dst_dir)))
    os.makedirs(dst)
    for name in ("t_values.p", f"null_max{suffix}.npz"):
        with open(os.path.join(src, name), "rb") as f, open(os.path.join(dst, name), "wb") as g:
            g.write(f.read())


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_package_resumes_from_the_others_artifacts(both_runs, artifacts, monkeypatch,
                                                        reader):
    ref, jcfg, got, tcfg = both_runs
    writer_out, writer_cfg = (ref, jcfg) if reader == "torch" else (got, tcfg)
    module = TP if reader == "torch" else JP
    out_dir = artifacts["tmp"] / f"resume_{reader}"
    _prefill(writer_cfg, out_dir)

    def refuse(*a, **k):
        raise AssertionError("a cached stage was recomputed")

    monkeypatch.setattr(module, "load_per_subject_scores", refuse)
    monkeypatch.setattr(module, "_stacked_null_scores", refuse)
    res = module.run(_config(module, artifacts, out_dir))
    for hemi in ("left", "right"):
        for m, v in writer_out["t_values"][hemi].items():
            np.testing.assert_array_equal(res["t_values"][hemi][m], v)
        # TFCE of the same t-values: the two native engines are one source
        np.testing.assert_array_equal(res["tfce_values"][hemi][jcfg.metric],
                                      writer_out["tfce_values"][hemi][jcfg.metric])
        np.testing.assert_array_equal(res["p_values"][hemi], writer_out["p_values"][hemi])
        np.testing.assert_array_equal(res["masks"][hemi], writer_out["masks"][hemi])
    np.testing.assert_array_equal(res["null_max_sorted"], writer_out["null_max_sorted"])


def test_keep_null_maps_matches_jax(both_runs, artifacts):
    _, jcfg, _, tcfg = both_runs
    tmp = artifacts["tmp"]
    jk = dataclasses.replace(jcfg, out_dir=str(tmp / "jax_keep"), keep_null_maps=True)
    tk = dataclasses.replace(tcfg, out_dir=str(tmp / "torch_keep"), keep_null_maps=True)
    j_res, t_res = JP.null_max_tfce_statistics(jk), TP.null_max_tfce_statistics(tk)
    np.testing.assert_allclose(t_res["null_max"], j_res["null_max"], rtol=1e-5)
    suffix = TP.get_hparam_suffix(tk)
    stacked = []
    for hemi in ("left", "right"):
        name = f"tfce_null_maps_{hemi}{suffix}.npz"
        t_maps = np.load(os.path.join(TP.permutation_results_dir(tk), name))["tfce"]
        j_maps = np.load(os.path.join(JP.permutation_results_dir(jk), name))["tfce"]
        assert t_maps.shape == j_maps.shape == (N_GROUP, artifacts["mesh"].n_vertices)
        np.testing.assert_allclose(t_maps, j_maps, rtol=1e-5, atol=1e-5)
        stacked.append(t_maps)
    both = np.concatenate(stacked, axis=1)
    np.testing.assert_allclose(np.nanmax(np.where(np.isnan(both), -np.inf, both), axis=1),
                               t_res["null_max"], atol=1e-5)


def test_cli_matches_run_and_refuses_unported_options(both_runs, artifacts):
    from multimodal_decoding_tpu_torch.cli import permutation_testing as cli

    _, _, got, tcfg = both_runs
    out_dir = str(artifacts["tmp"] / "torch_cli")
    argv = ["--subjects", *SUBJECTS, "--model", "clip", "--mod-specific-images-model", "clip",
            "--mod-specific-captions-model", "clip", "--n-neighbors", "6",
            "--l2-regularization-alpha", "1.0",
            "--n-permutations-group-level", str(N_GROUP), "--p-value-threshold", "0.06",
            "--mesh-dir", artifacts["mesh_dir"], "--searchlight-out-dir", artifacts["sl_out"],
            "--out-dir", out_dir, "--device", "cpu"]
    res = cli.main(argv)
    for hemi in ("left", "right"):
        np.testing.assert_array_equal(res["p_values"][hemi], got["p_values"][hemi])
        np.testing.assert_array_equal(res["masks"][hemi], got["masks"][hemi])
    assert _files(out_dir) == _files(tcfg.out_dir)
    # --sharded and run(mesh=...) split the null over the world's ranks: here a
    # gloo world of one, which must give the same artifacts and statistics
    import torch.distributed as dist

    from multimodal_decoding_tpu_torch.parallel.mesh import vertex_mesh

    sharded_dir = str(artifacts["tmp"] / "torch_cli_sharded")
    mesh_cfg = dataclasses.replace(tcfg, out_dir=str(artifacts["tmp"] / "torch_mesh"))
    try:
        by_cli = cli.main(argv[:-4] + ["--out-dir", sharded_dir, "--device", "cpu",
                                       "--sharded"])
        by_run = TP.run(mesh_cfg, mesh=vertex_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    for sharded in (by_cli, by_run):
        for hemi in ("left", "right"):
            np.testing.assert_array_equal(sharded["p_values"][hemi], got["p_values"][hemi])
            np.testing.assert_array_equal(sharded["masks"][hemi], got["masks"][hemi])
        np.testing.assert_array_equal(sharded["null_max_sorted"], got["null_max_sorted"])
    assert _files(sharded_dir) == _files(mesh_cfg.out_dir) == _files(tcfg.out_dir)


@pytest.mark.parametrize("additional_imagery", [False, True])
def test_process_scores_equal_jax(additional_imagery):
    rng = np.random.RandomState(0)
    v_total, v_valid = 12, 9
    nan_loc = np.zeros(v_total, dtype=bool)
    nan_loc[[0, 5, 11]] = True
    base = [JM.ACC_CAPTIONS, JM.ACC_IMAGES, JM.ACC_IMAGERY, JM.ACC_IMAGERY_WHOLE_TEST,
            JM.ACC_IMAGERY + "_no_std", JM.ACC_IMAGERY_WHOLE_TEST + "_no_std"]

    def fake(extra_axis):
        shape = (v_valid, 4) if extra_axis else (v_valid,)
        return {m: rng.rand(*shape).astype(np.float32) for m in base}

    for extra_axis in (False, True):
        sa, sc, si = fake(extra_axis), fake(extra_axis), fake(extra_axis)
        for caps, imgs in ((sc, si), (None, None)):
            got = TP.process_scores(sa, caps, imgs, nan_loc, additional_imagery)
            ref = JP.process_scores(sa, caps, imgs, nan_loc, additional_imagery)
            assert sorted(got) == sorted(ref)
            for k, v in ref.items():
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v, err_msg=k)
