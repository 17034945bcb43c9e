"""Port parity: fast math (bf16 ``X_all`` storage, products at ``"default"``).

Both packages' ``run_searchlight`` and ``run_study`` CLIs run with
``--fast-math`` on small synthetic subjects (the port with ``--device cpu``);
each package reads the other's artifacts.  JAX on the CPU runs DEFAULT in
float32 where the port rounds float32 operands to bf16 (ROADMAP C), so the
two fits differ in the last bf16 places: the selected alphas are held to
the JAX package's on at least 90% of the vertices, and each score map to a
mean absolute difference of 0.02 (an imagery accuracy moves in steps of 1/6,
so a near-tie that flips moves one vertex by that much; the planted signal
keeps both far above chance).  Streamed bf16 ingestion must equal the eager float32 matrix
cast to bf16, element for element.
"""

import os
import sys

import numpy as np
import torch

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.io import artifacts as jax_artifacts
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch.data.preprocess import standardize_fmri_betas
from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu_torch.decoding import searchlight as TS
from multimodal_decoding_tpu_torch.io import artifacts as torch_artifacts
from multimodal_decoding_tpu_torch.io.surface import icosphere, write_freesurfer_geometry
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.parallel.ingest import (
    NpzMemberReader,
    streamed_scaler_fit,
    streamed_x_all_device,
)
from tests.test_torch_ingest import _save_cache, _splits
from tests.test_torch_searchlight import _cli_args, _results, dataset  # noqa: F401 (fixture)

ALPHA_AGREEMENT_MIN = 0.9
SCORE_DELTA_MAX = 0.02  # mean |delta| of a map


def _assert_close_runs(res_t, res_j):
    agree = np.mean(res_t["best_alpha"] == res_j["best_alpha"])
    assert agree >= ALPHA_AGREEMENT_MIN, agree
    assert sorted(res_t["score_maps"]) == sorted(res_j["score_maps"])
    for m, v in res_j["score_maps"].items():
        assert np.abs(res_t["score_maps"][m] - v).mean() <= SCORE_DELTA_MAX, m
    assert np.mean(res_t["score_maps"][M.ACC_CAPTIONS]) > 0.9  # planted signal


def test_run_searchlight_fast_math_through_both_clis(dataset, tmp_path, monkeypatch):
    from multimodal_decoding_tpu.cli.run_searchlight import main as jax_main
    from multimodal_decoding_tpu_torch.cli.run_searchlight import main as torch_main

    jax_out, torch_out = str(tmp_path / "jax_sl"), str(tmp_path / "torch_sl")
    monkeypatch.setattr(sys, "argv", ["prog", *_cli_args(dataset, jax_out), "--fast-math"])
    jax_main()
    torch_main(_cli_args(dataset, torch_out) + ["--fast-math", "--device", "cpu"])
    jax_pickle, jax_null = _results(jax_out)
    torch_pickle, torch_null = _results(torch_out)
    assert os.path.relpath(jax_pickle, jax_out) == os.path.relpath(torch_pickle, torch_out)
    res_j = torch_artifacts.load_pickle(jax_pickle)
    res_t = jax_artifacts.load_pickle(torch_pickle)
    assert set(res_t) == set(res_j)
    _assert_close_runs(res_t, res_j)
    null_t = jax_artifacts.load_null_scores_npz(torch_null)
    null_j = torch_artifacts.load_null_scores_npz(jax_null)
    assert sorted(null_t) == sorted(null_j)
    for m, v in null_j.items():
        assert null_t[m].shape == v.shape and np.all(np.isfinite(null_t[m])), m

    # the streamed path (the eager run wrote the betas npz cache) stores the
    # same bf16 X_all, so it writes the eager fast-math run's maps
    streamed = TS.run(TS.SearchlightConfig(
        betas_dir=os.path.join(dataset["betas_dir"], "surface"),
        mesh_coords={"left": _mesh_coords(dataset)},
        model=dataset["model"], subjects=["sub-01"], hemis=["left"], n_neighbors=5,
        alphas_cv=[0.1, 10.0, 1000.0], create_null_distr=True, n_permutations_per_subject=6,
        block_size=8, out_dir=str(tmp_path / "streamed"), progress=False, fast_math=True,
        stream_ingest="on", device="cpu"))
    res_s = torch_artifacts.load_pickle(streamed[0])
    np.testing.assert_array_equal(res_s["best_alpha"], res_t["best_alpha"])
    for m, v in res_t["score_maps"].items():
        np.testing.assert_array_equal(res_s["score_maps"][m], v, err_msg=m)


def _mesh_coords(dataset):
    from multimodal_decoding_tpu_torch.io.surface import read_freesurfer_geometry

    return read_freesurfer_geometry(
        os.path.join(dataset["mesh_dir"], "fsaverage7", "lh.inflated")).coordinates


def test_run_study_fast_math_through_both_clis(tmp_path, monkeypatch):
    from multimodal_decoding_tpu.cli.run_study import main as jax_main
    from multimodal_decoding_tpu_torch.cli.run_study import main as torch_main
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle

    mesh = icosphere(subdivisions=1, radius=50.0)
    subjects = ["sub-01", "sub-02"]
    for i, subj in enumerate(subjects):
        make_synthetic_dataset(str(tmp_path), subject=subj, n_train=40,
                               n_vertices=mesh.n_vertices, latent_dim=6, beta_seed=10 + i)
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "FMRI_STIM_INFO_DIR", str(tmp_path / "stim_info"))
        monkeypatch.setattr(cfg, "LATENT_FEATURES_DIR", str(tmp_path / "nn_features"))
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "cache"))
    _load_feature_pickle.cache_clear()
    os.makedirs(tmp_path / "surfaces" / "fsaverage7")
    write_freesurfer_geometry(str(tmp_path / "surfaces" / "fsaverage7" / "lh.inflated"), mesh)

    def argv(pkg):
        return ["--betas-dir", str(tmp_path / "betas" / "surface"),
                "--mesh-dir", str(tmp_path / "surfaces"), "--model", "clip",
                "--subjects", *subjects, "--hemis", "left",
                "--l2-regularization-alpha", "cv", "--n-neighbors", "6",
                "--n-permutations-per-subject", "6", "--n-permutations-group-level", "12",
                "--p-value-threshold", "0.1", "--block-size", "8", "--fast-math",
                "--searchlight-out-dir", str(tmp_path / pkg / "sl"),
                "--permutation-out-dir", str(tmp_path / pkg / "perm")]

    monkeypatch.setattr(sys, "argv", ["prog", *argv("jax")])
    jax_main()
    stats = torch_main(argv("torch") + ["--device", "cpu"])
    _load_feature_pickle.cache_clear()
    p_vals = stats["p_values"]["left"]
    assert p_vals.shape == (mesh.n_vertices,)
    assert np.isfinite(p_vals).sum() >= mesh.n_vertices - 3  # the synthetic NaN vertices
    assert stats["masks"]["left"].sum() > 0  # the planted signal is significant

    def found(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, fs in os.walk(root) for f in fs if f == "alpha_cv.p")

    jax_sl, torch_sl = str(tmp_path / "jax" / "sl"), str(tmp_path / "torch" / "sl")
    paths = found(torch_sl)
    assert paths == found(jax_sl) and len(paths) == 3 * len(subjects)  # 3 training modes
    for rel in paths:
        res_t = jax_artifacts.load_pickle(os.path.join(torch_sl, rel))
        res_j = torch_artifacts.load_pickle(os.path.join(jax_sl, rel))
        _assert_close_runs(res_t, res_j)


def test_streamed_bf16_ingestion_is_the_eager_cast(tmp_path):
    train, test, imag = _splits(seed=4)
    eager = torch.from_numpy(np.concatenate(standardize_fmri_betas(train, test, imag)))
    readers = [NpzMemberReader(_save_cache(tmp_path / f"{n}.npz", a))
               for n, a in (("train", train), ("test", test), ("imag", imag))]
    keep = ~np.isnan(readers[0].read_row(0))
    mean32, scale32 = streamed_scaler_fit(readers[0], keep)
    for chunk_rows in (7, None):
        X = streamed_x_all_device(readers, keep, mean32, scale32, device="cpu",
                                  chunk_rows=chunk_rows, dtype=torch.bfloat16)
        assert X.dtype == torch.bfloat16
        assert torch.equal(X, eager.to(torch.bfloat16))
