"""Port parity end to end: the whole-brain decoder of both packages.

``decoding/whole_brain.run`` of the JAX package and of the port (on the CPU,
``device="cpu"``) decode one synthetic subject (both surface hemispheres,
planted signal).  Selected alphas must be equal, predictions within 1e-4
relative and every score within 1e-4; each package reads and skips the
other's ``results.p``.  On the CPU both select with the strict Cholesky
oracle (``default_wb_cv_solver``).
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu.decoding import whole_brain as JW
from multimodal_decoding_tpu.ops import metrics as JM
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch import interop
from multimodal_decoding_tpu_torch.decoding import whole_brain as TW
from multimodal_decoding_tpu_torch.ops import metrics as TM

ALPHAS = (1e0, 1e2, 1e4)
PRED_TOL = 1e-4   # relative, predictions of two float32 Cholesky refits
SCORE_TOL = 1e-4  # every score (BASELINE tolerance)


@pytest.fixture()
def dataset(tmp_path, monkeypatch):
    info = make_synthetic_dataset(str(tmp_path), n_train=50, n_vertices=30, latent_dim=8,
                                  surface=True)
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "FMRI_STIM_INFO_DIR", info["stim_info_dir"])
        monkeypatch.setattr(cfg, "LATENT_FEATURES_DIR", info["features_dir"])
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "cache"))
    from multimodal_decoding_tpu.data.features import _load_feature_pickle as jax_cache
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle as torch_cache

    jax_cache.cache_clear()
    torch_cache.cache_clear()
    return info


def _cfg(package, dataset, out_dir, **kw):
    extra = {"device": "cpu"} if package is TW else {}
    return package.WholeBrainConfig(
        betas_dir=dataset["betas_dir"], subjects=[dataset["subject"]],
        models=kw.pop("models", [dataset["model"]]), alphas=ALPHAS, surface=True,
        out_dir=out_dir, **extra, **kw)


def _results_files(out_dir):
    return sorted(os.path.join(root, f) for root, _, files in os.walk(out_dir)
                  for f in files if f == "results.p")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_both_packages_decode_alike_and_read_each_other(dataset, tmp_path):
    jax_out, torch_out = str(tmp_path / "jax_wb"), str(tmp_path / "torch_wb")
    (ref,) = JW.run(_cfg(JW, dataset, jax_out))
    (got,) = TW.run(_cfg(TW, dataset, torch_out))

    assert got["alpha"] == ref["alpha"]
    assert set(got) == set(ref)
    assert _rel(got["predictions"], ref["predictions"]) <= PRED_TOL
    assert _rel(got["imagery_predictions"], ref["imagery_predictions"]) <= PRED_TOL
    np.testing.assert_allclose(got["cv_mean_scores"], ref["cv_mean_scores"], rtol=0, atol=1e-5)
    score_keys = [k for k in ref if k.startswith("pairwise_acc")]
    assert TM.ACC_IMAGERY_WHOLE_TEST in score_keys and len(score_keys) == 6
    for k in score_keys:
        assert abs(got[k] - ref[k]) <= SCORE_TOL, k
    assert got[TM.ACC_CAPTIONS] > 0.8 and got[TM.ACC_IMAGES] > 0.8  # planted signal
    for k in ("stimulus_ids", "stimulus_types", "imagery_stimulus_ids", "latents",
              "imagery_latents", "num_voxels", "mask", "training_mode", "resolution"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    # the port's pickle holds numpy, never tensors, at the JAX package's path
    (jax_file,), (torch_file,) = _results_files(jax_out), _results_files(torch_out)
    assert os.path.relpath(jax_file, jax_out) == os.path.relpath(torch_file, torch_out)
    with open(torch_file, "rb") as f:
        stored = pickle.load(f)
    assert not any(isinstance(v, torch.Tensor) for v in stored.values())
    assert isinstance(stored["predictions"], np.ndarray)
    # each package scores the other's stored predictions as the writer did
    with open(jax_file, "rb") as f:
        jax_stored = pickle.load(f)
    re_jax = JM.calc_all_pairwise_accuracy_scores(
        stored["latents"], stored["predictions"], stored["stimulus_types"],
        stored["imagery_latents"], stored["imagery_predictions"])
    re_torch = TM.calc_all_pairwise_accuracy_scores(
        jax_stored["latents"], jax_stored["predictions"], jax_stored["stimulus_types"],
        jax_stored["imagery_latents"], jax_stored["imagery_predictions"], device="cpu")
    for k in score_keys:
        assert abs(float(re_jax[k]) - stored[k]) <= SCORE_TOL, k
        assert abs(float(re_torch[k]) - jax_stored[k]) <= SCORE_TOL, k

    # skip-if-exists: a rerun skips, and so does each package on the other's output
    assert TW.run(_cfg(TW, dataset, torch_out)) == []
    assert TW.run(_cfg(TW, dataset, jax_out)) == []
    assert JW.run(_cfg(JW, dataset, torch_out)) == []
    # --overwrite decodes again
    assert len(TW.run(_cfg(TW, dataset, torch_out, overwrite=True))) == 1


def test_multi_model_sweep_builds_the_gram_once(dataset, tmp_path, monkeypatch):
    src = os.path.join(dataset["features_dir"], f"{dataset['model']}.p")
    shutil.copy(src, os.path.join(dataset["features_dir"], "siglip.p"))
    calls = []
    orig_init = TW.GramCache.__init__

    def counting_init(self, *a, **k):
        calls.append(1)
        orig_init(self, *a, **k)

    monkeypatch.setattr(TW.GramCache, "__init__", counting_init)
    results = TW.run(_cfg(TW, dataset, str(tmp_path / "sweep"),
                          models=[dataset["model"], "siglip"]))
    assert len(results) == 2
    assert len(calls) == 1
    assert results[0][TM.ACC_CAPTIONS] == results[1][TM.ACC_CAPTIONS]


def test_decode_single_starts_from_the_jax_gram_cache(dataset):
    """The JAX GramCache's kernels, carried over by interop, give the JAX
    decode: same alpha, predictions within 1e-4."""
    from multimodal_decoding_tpu_torch.data.betas import get_fmri_data
    from multimodal_decoding_tpu_torch.data.features import get_latent_features
    from multimodal_decoding_tpu_torch.data.preprocess import (
        standardize_fmri_betas,
        standardize_latents,
    )

    subject = dataset["subject"]
    betas = [get_fmri_data(dataset["betas_dir"], subject, s, surface=True)[0]
             for s in ("train", "test", "imagery")]
    betas = standardize_fmri_betas(*betas)
    fc = torch_config.LatentFeatsConfig(dataset["model"], verbose=False)
    lats = standardize_latents(*[get_latent_features(fc, subject, s)
                                 for s in ("train", "test", "imagery")])
    jax_cache = JW.GramCache(*betas)
    ref = JW.decode_single(*betas, *lats, ALPHAS, gram_cache=jax_cache)
    cache = interop.gram_cache_from_numpy(np.asarray(jax_cache.K), np.asarray(jax_cache.K_test),
                                          np.asarray(jax_cache.K_imag), device="cpu")
    timings = {}
    got = TW.decode_single(*betas, *lats, ALPHAS, gram_cache=cache, timings=timings)
    assert got[0] == ref[0]
    assert _rel(got[1], ref[1]) <= PRED_TOL and _rel(got[2], ref[2]) <= PRED_TOL
    assert set(timings) == {"cv_s", "refit_s", "predict_s"}
    # and the port's own cache holds the same kernels
    own = TW.GramCache(*betas, device="cpu")
    assert _rel(own.K, jax_cache.K) <= 1e-5 and _rel(own.K_test, jax_cache.K_test) <= 1e-5


def test_cli_runs_on_the_cpu_when_asked(dataset, tmp_path):
    from multimodal_decoding_tpu_torch.cli import decode_whole_brain as cli

    argv = ["--betas-dir", dataset["betas_dir"], "--subjects", dataset["subject"],
            "--models", dataset["model"], "--surface", "--l2-regularization-alphas",
            *map(str, ALPHAS), "--out-dir", str(tmp_path / "cli_wb"), "--device", "cpu"]
    (res,) = cli.main(argv)
    assert res[TM.ACC_CAPTIONS] > 0.8
    assert len(_results_files(str(tmp_path / "cli_wb"))) == 1
    assert cli.main(argv) == []
    # --multichip feature-shards the gram over the world: a gloo world of one here
    import torch.distributed as dist

    multi_argv = argv[:argv.index("--out-dir")] + [
        "--out-dir", str(tmp_path / "cli_wb_multichip"), "--device", "cpu", "--multichip"]
    try:
        (multi,) = cli.main(multi_argv)
    finally:
        dist.destroy_process_group()
    for m in (TM.ACC_CAPTIONS, TM.ACC_IMAGES, TM.ACC_IMAGERY, TM.ACC_IMAGERY_WHOLE_TEST):
        assert multi[m] == res[m]
    np.testing.assert_array_equal(multi["predictions"], res["predictions"])
    assert len(_results_files(str(tmp_path / "cli_wb_multichip"))) == 1
    args = cli.get_args([])
    assert args.device == "cuda"
    assert args.l2_regularization_alphas == list(torch_config.DEFAULT_ALPHAS)


def test_solver_defaults_and_refusals(dataset, tmp_path):
    """The CPU's solver default, and the feature mesh: run(mesh="auto") and a
    feature-sharded GramCache on a gloo world of one match the unsharded ones."""
    import torch.distributed as dist

    from multimodal_decoding_tpu_torch.parallel.mesh import feature_mesh

    assert TW.default_wb_cv_solver("cpu") is None
    rng = np.random.RandomState(3)
    betas = [rng.randn(n, 37).astype(np.float32) for n in (12, 4, 3)]
    try:
        (sharded,) = TW.run(_cfg(TW, dataset, str(tmp_path / "m"), mesh="auto"))
        cache = TW.GramCache(*betas, mesh=feature_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    (plain,) = TW.run(_cfg(TW, dataset, str(tmp_path / "p")))
    assert sharded["alpha"] == plain["alpha"]
    np.testing.assert_array_equal(sharded["predictions"], plain["predictions"])
    own = TW.GramCache(*betas, device="cpu")
    for name in ("K", "K_test", "K_imag"):
        assert torch.equal(getattr(cache, name), getattr(own, name))
