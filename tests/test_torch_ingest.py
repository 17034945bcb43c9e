"""Port parity: streamed betas ingestion (parallel/ingest.py) and ``stream_ingest``.

The streamed statistics must equal the JAX package's and the port's eager
ones bit for bit, the streamed ``X_all`` must equal the eager concatenation
element for element, and a searchlight run that streams must write the same
score maps and nulls as the eager run and as the JAX package's streamed
run.  On the CPU the device tensor is filled through one reused host buffer;
the card's two pinned buffers are held to the eager tensor by chip_smoke.py
phase ``ingest``.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.parallel import ingest as JI
from multimodal_decoding_tpu_torch.data.preprocess import standardize_fmri_betas
from multimodal_decoding_tpu_torch.decoding import searchlight as TS
from multimodal_decoding_tpu_torch.io import artifacts
from multimodal_decoding_tpu_torch.parallel.ingest import (
    NpzMemberReader,
    default_chunk_rows,
    streamed_scaler_fit,
    streamed_x_all_device,
)
from tests.test_torch_searchlight import dataset  # noqa: F401  (fixture)
from tests.test_torch_searchlight import NULL_RANK_COUNTS, _jittered_icosphere

# one rank count of a caption or image null score (70 test stimuli each)
ONE_COUNT = 1.0 / (70 * 70 - 70)


def _save_cache(path, arr):
    np.savez(str(path), betas=arr, stim_ids=np.arange(len(arr)),
             stim_types=np.zeros(len(arr), np.int64))
    return str(path)


def _splits(seed=0, v=33):
    rng = np.random.RandomState(seed)
    train = (rng.normal(size=(40, v)) * rng.uniform(0.1, 10.0, v)).astype(np.float32)
    test = rng.normal(size=(6, v)).astype(np.float32)
    imag = rng.normal(size=(3, v)).astype(np.float32)
    for a in (train, test, imag):
        a[:, 2] = np.nan
        a[:, 9] = np.nan
    train[:, 5] = -1.5  # zero std: scale 1, as sklearn's scaler
    return train, test, imag


def test_npz_member_reader_roundtrip(tmp_path):
    arr = np.random.RandomState(1).normal(size=(23, 17)).astype(np.float32)
    path = _save_cache(tmp_path / "c.npz", arr)
    r, jr = NpzMemberReader(path), JI.NpzMemberReader(path)
    assert r.shape == jr.shape == (23, 17) and r.dtype == jr.dtype == np.float32
    got = np.concatenate([v.copy() for _, v in r.iter_row_chunks(5)])
    np.testing.assert_array_equal(got, arr)
    assert [r0 for r0, _ in r.iter_row_chunks(5)] == [0, 5, 10, 15, 20]
    for i in (0, 7, 22):
        np.testing.assert_array_equal(r.read_row(i), arr[i])
        np.testing.assert_array_equal(r.read_row(i), jr.read_row(i))
    assert default_chunk_rows(163_842) == JI.default_chunk_rows(163_842)

    comp = str(tmp_path / "z.npz")
    np.savez_compressed(comp, betas=arr)
    with pytest.raises(ValueError, match="compressed"):
        NpzMemberReader(comp)
    with pytest.raises(ValueError, match="no member"):
        NpzMemberReader(path, member="latents")


@pytest.mark.parametrize("chunk_rows", [1, 7, 40, None])
def test_streamed_scaler_fit_is_bitwise_the_eager_and_the_jax_statistics(tmp_path, chunk_rows):
    train, _, _ = _splits()
    keep = ~np.isnan(train[0])
    reader = NpzMemberReader(_save_cache(tmp_path / "t.npz", train))
    mean32, scale32 = streamed_scaler_fit(reader, keep, chunk_rows=chunk_rows)
    j_mean, j_scale = JI.streamed_scaler_fit(JI.NpzMemberReader(reader.path), keep,
                                             chunk_rows=chunk_rows)
    np.testing.assert_array_equal(mean32, j_mean)
    np.testing.assert_array_equal(scale32, j_scale)
    # the port's eager statistics, as standardize_fmri_betas computes them
    kept = np.ascontiguousarray(train[:, keep])
    std64 = np.sqrt(np.var(kept, axis=0, dtype=np.float64))
    np.testing.assert_array_equal(mean32, kept.mean(axis=0, dtype=np.float64).astype(np.float32))
    np.testing.assert_array_equal(scale32, np.where(std64 == 0.0, 1.0, std64).astype(np.float32))
    assert scale32[4] == 1.0  # column 5, after column 2 (NaN) is dropped


@pytest.mark.parametrize("chunk_rows", [7, None])
def test_streamed_x_all_device_equals_the_eager_x_all(tmp_path, chunk_rows):
    train, test, imag = _splits(seed=2)
    eager = np.concatenate(standardize_fmri_betas(train, test, imag))
    readers = [NpzMemberReader(_save_cache(tmp_path / f"{n}.npz", a))
               for n, a in (("train", train), ("test", test), ("imag", imag))]
    keep = ~np.isnan(readers[0].read_row(0))
    mean32, scale32 = streamed_scaler_fit(readers[0], keep, chunk_rows=chunk_rows)
    X = streamed_x_all_device(readers, keep, mean32, scale32, device="cpu",
                              chunk_rows=chunk_rows)
    assert X.dtype == torch.float32 and X.device.type == "cpu"
    assert torch.equal(X, torch.from_numpy(eager))
    with pytest.raises(ValueError, match="float32"):
        streamed_x_all_device([NpzMemberReader(_save_cache(tmp_path / "f64.npz",
                                                           train.astype(np.float64)))],
                              keep, mean32, scale32, device="cpu")


def _sl_config(module, dataset, out_dir, **kw):
    extra = {"device": "cpu"} if module is TS else {}
    return module.SearchlightConfig(
        betas_dir=os.path.join(dataset["betas_dir"], "surface"),
        mesh_coords={"left": _jittered_icosphere(1, 50.0).coordinates},
        model=dataset["model"], subjects=["sub-01"], hemis=["left"], n_neighbors=5,
        alphas_cv=[0.1, 10.0, 1000.0], create_null_distr=True, n_permutations_per_subject=6,
        block_size=8, out_dir=out_dir, progress=False, **extra, **kw)


def _load(path):
    res = artifacts.load_pickle(path)
    return res, artifacts.load_null_scores_npz(os.path.join(os.path.dirname(path),
                                                            "null_distr.npz"))


def _assert_same_run(got, ref, near_tie_counts=0):
    """Equal maps, alphas and nulls; ``near_tie_counts``: across packages the
    caption/image nulls may differ by that many rank counts where float32
    rounding decides a near-tie (tests/test_torch_searchlight.py)."""
    (res, null), (ref_res, ref_null) = got, ref
    assert sorted(res["score_maps"]) == sorted(ref_res["score_maps"])
    for m, v in ref_res["score_maps"].items():
        np.testing.assert_array_equal(res["score_maps"][m], v, err_msg=m)
    np.testing.assert_array_equal(res["best_alpha"], ref_res["best_alpha"])
    np.testing.assert_array_equal(res["nan_locations"], ref_res["nan_locations"])
    assert sorted(null) == sorted(ref_null)
    for m, v in ref_null.items():
        if near_tie_counts and m in NULL_RANK_COUNTS:
            assert np.abs(null[m] - v).max() <= near_tie_counts * ONE_COUNT + 1e-7, m
            assert np.mean(null[m] == v) > 0.95, m
        else:
            np.testing.assert_array_equal(null[m], v, err_msg=m)


def test_run_streams_the_same_maps_as_eager_and_as_jax(dataset, tmp_path, capsys):
    from multimodal_decoding_tpu.decoding import searchlight as JS

    # the eager run writes the npz betas cache that the streamed runs read
    (off,) = TS.run(_sl_config(TS, dataset, str(tmp_path / "off"), stream_ingest="off"))
    capsys.readouterr()
    (on,) = TS.run(_sl_config(TS, dataset, str(tmp_path / "on"), stream_ingest="on"))
    assert "Streaming ingestion" in capsys.readouterr().out
    (jax_on,) = JS.run(_sl_config(JS, dataset, str(tmp_path / "jax_on"), stream_ingest="on"))
    _assert_same_run(_load(on), _load(off))
    _assert_same_run(_load(on), _load(jax_on), near_tie_counts=2)


def test_auto_streams_only_over_the_size_rule(dataset, tmp_path, monkeypatch, capsys):
    (off,) = TS.run(_sl_config(TS, dataset, str(tmp_path / "off"), stream_ingest="off"))
    capsys.readouterr()
    TS.run(_sl_config(TS, dataset, str(tmp_path / "small"), stream_ingest="auto"))
    assert "Streaming ingestion" not in capsys.readouterr().out  # a few KB: eager
    monkeypatch.setattr(TS, "STREAM_AUTO_MIN_BYTES", 0)
    monkeypatch.setenv("MMD_STREAM_INGEST", "auto")
    (auto,) = TS.run(_sl_config(TS, dataset, str(tmp_path / "auto")))
    assert "Streaming ingestion" in capsys.readouterr().out
    _assert_same_run(_load(auto), _load(off))


def test_on_without_a_cache_raises_in_both_packages(dataset, tmp_path, monkeypatch):
    from multimodal_decoding_tpu.decoding import searchlight as JS
    from multimodal_decoding_tpu_torch import config as torch_config

    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "empty_cache"))
    for module in (TS, JS):
        with pytest.raises(FileNotFoundError, match="betas npz cache"):
            module.run(_sl_config(module, dataset, str(tmp_path / "sl"), stream_ingest="on"))
    assert not os.path.exists(tmp_path / "sl")  # nothing written
    with pytest.raises(ValueError, match="stream_ingest"):
        TS.run(_sl_config(TS, dataset, str(tmp_path / "sl"), stream_ingest="sometimes"))

