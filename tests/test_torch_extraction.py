"""Port parity: Gabor and motion-energy banks, the extraction harness and its
pickle, the feature CLI, and the profiling helpers.

Each port function gets the JAX package's function's seeded inputs; the
tolerance is stated beside each comparison.  The banks run on the CPU here
(``device="cpu"``); on the card they are phase ``extract`` of chip_smoke.py.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY
from multimodal_decoding_tpu.extraction import gabor as JG
from multimodal_decoding_tpu.extraction import harness as JH
from multimodal_decoding_tpu.extraction import motion_energy as JME
from multimodal_decoding_tpu_torch.extraction import gabor as TG
from multimodal_decoding_tpu_torch.extraction import harness as TH
from multimodal_decoding_tpu_torch.extraction import motion_energy as TME

# Both packages sum in float32, in another order.  The error of a float32 sum
# scales with the sum of its terms' magnitudes, not with its result (the
# Gabor means of zero-sum kernels are rounding noise), so each feature is held
# within TOL of its float32 error scale: for a Gabor mean S = mean|img| x
# sum|k| (the mean over pixels of sum |img k| of a circular conv), for a
# variance S^2; for a motion-energy channel sum |img| x max(|sin|, |cos|).
# Each package is ~4e-7 of that scale from float64 on these inputs.
TOL = 1e-5


def gabor_scale(imgs, bank):
    s = (np.abs(np.asarray(imgs, np.float64)).mean(axis=(1, 2))[:, None]
         * np.abs(np.asarray(bank, np.float64)).sum(axis=(1, 2))[None])
    return np.stack([s, s * s], axis=-1).reshape(len(s), -1)


def moten_scale(imgs, sin_bank, cos_bank):
    filt = np.maximum(np.abs(sin_bank), np.abs(cos_bank)).reshape(len(sin_bank), -1)
    return np.abs(np.asarray(imgs, np.float64)).reshape(len(imgs), -1) @ filt.T.astype(np.float64)


def _within(got, ref, scale):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - ref)
    assert np.all(err <= TOL * scale), np.max(err / scale)


def make_dataset(cls, tmp_path, n=7):
    """A dataset of in-memory PIL images on disk (the JAX tests' helper)."""
    from PIL import Image

    ds = cls(img_paths={100 + i: f"img_{i}.png" for i in range(n)},
             captions={100 + i: f"a photo of thing number {i}" for i in range(n)},
             root=str(tmp_path))
    rng = np.random.RandomState(0)
    for i in range(n):
        arr = rng.randint(0, 255, (32, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(str(tmp_path), f"img_{i}.png"))
    return ds


def test_gabor_bank_equals_jax():
    bank = TG._padded_bank(TG.make_gabor_filterbank())
    np.testing.assert_array_equal(bank, JG._padded_bank(JG.make_gabor_filterbank()))
    assert bank.shape == (160, 43, 43)
    k = TG.gabor_kernel(0.25, theta=np.pi / 4, sigma_x=3, sigma_y=3)
    np.testing.assert_array_equal(k, JG.gabor_kernel(0.25, theta=np.pi / 4, sigma_x=3, sigma_y=3))


def test_gabor_features_match_jax(rng):
    """The full 160-kernel bank on 3 seeded images, port against JAX."""
    imgs = rng.rand(3, 40, 36).astype(np.float32) * 255
    ref = JG.compute_gabor_feats_batch(imgs)
    got = TG.compute_gabor_feats_batch(imgs, device="cpu")
    assert got.shape == (3, 320)
    _within(got.numpy(), ref, gabor_scale(imgs, TG._padded_bank(TG.make_gabor_filterbank())))


def test_gabor_features_match_scipy(rng):
    """Circular conv + mean/var pooling == scipy.ndimage (the JAX test's case
    and bar: rtol 2e-3 / atol 2e-2)."""
    from scipy import ndimage

    kernels = TG.make_gabor_filterbank()[:6]
    bank = TG._padded_bank(kernels)
    imgs = rng.rand(2, 40, 40).astype(np.float32) * 255
    ours = TG.compute_gabor_feats_batch(imgs, bank, device="cpu").numpy()
    for b in range(2):
        ref = []
        for k in kernels:
            filt = ndimage.convolve(imgs[b].astype(np.float64), k, mode="wrap")
            ref += [filt.mean(), filt.var()]
        np.testing.assert_allclose(ours[b], np.asarray(ref), rtol=2e-3, atol=2e-2)


def test_gabor_float64_tensor_stays_float64(rng):
    imgs = torch.as_tensor(rng.rand(2, 24, 24)) * 255
    bank = TG._padded_bank(TG.make_gabor_filterbank()[:4])
    out = TG.compute_gabor_feats_batch(imgs, bank)
    assert out.dtype == torch.float64
    _within(TG.compute_gabor_feats_batch(imgs.float(), bank).numpy(), out.numpy(),
            gabor_scale(imgs.numpy(), bank))


@pytest.mark.parametrize("size", [32, 96])
def test_motion_energy_matches_jax(rng, size):
    """The pyramid equal to the JAX package's; energies within the bar.  At
    96 px (the CLI's size) the bank has 1,361 channels."""
    sin_b, cos_b, channels = TME.build_spatial_pyramid(size)
    j_sin, j_cos, j_channels = JME.build_spatial_pyramid(size)
    np.testing.assert_array_equal(sin_b, j_sin)
    np.testing.assert_array_equal(cos_b, j_cos)
    assert channels == j_channels
    if size == 96:
        assert len(channels) == 1361
    imgs = rng.rand(3, size, size).astype(np.float32) * 255
    got = TME.motion_energy_features(imgs, sin_b, cos_b, device="cpu")
    _within(got.numpy(), JME.motion_energy_features(imgs, j_sin, j_cos),
            moten_scale(imgs, sin_b, cos_b))
    # the bank is built from the image size when not given
    np.testing.assert_array_equal(TME.motion_energy_features(imgs, device="cpu").numpy(),
                                  got.numpy())
    rgb = rng.randint(0, 255, (4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TME.rgb_to_luminance(rgb), JME.rgb_to_luminance(rgb))


def test_harness_pickle_schema_equals_jax(tmp_path):
    """run_extraction: the same pickle from both packages, and the port's
    data layer reads it."""
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle

    def extract(ids, captions, images):
        assert len(ids) <= 3 and len(images) == len(ids)
        return {VISION_CLS_FEAT_KEY: np.ones((len(ids), 4), np.float32) * np.asarray(ids)[:, None],
                LANG_CLS_FEAT_KEY: np.zeros((len(ids), 4), np.float32)}

    out = {}
    for name, H in (("jax", JH), ("torch", TH)):
        os.makedirs(tmp_path / name)
        ds = make_dataset(H.StimuliDataset, tmp_path / name)
        path = str(tmp_path / name / "toy.p")
        feats = H.run_extraction(extract, "toy", ds, batch_size=3, out_path=path, progress=False)
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
        assert feats.keys() == out[name].keys() == set(ds.stimuli_ids)
    for sid, row in out["jax"].items():
        assert out["torch"][sid].keys() == row.keys()
        for key, v in row.items():
            assert out["torch"][sid][key].dtype == np.float32
            np.testing.assert_array_equal(out["torch"][sid][key], v)
    read = _load_feature_pickle(str(tmp_path / "torch" / "toy.p"))
    assert read[100][VISION_CLS_FEAT_KEY][0] == 100


def test_external_feature_import_equals_jax(tmp_path):
    ids = [5, 9, 11]
    arr = np.arange(9, dtype=np.float32).reshape(3, 3)
    got = TH.import_external_features(ids, {LANG_CLS_FEAT_KEY: arr}, "glow",
                                      out_path=str(tmp_path / "t.p"))
    ref = JH.import_external_features(ids, {LANG_CLS_FEAT_KEY: arr}, "glow",
                                      out_path=str(tmp_path / "j.p"))
    with open(tmp_path / "t.p", "rb") as f:
        stored = pickle.load(f)
    for sid in ids:
        np.testing.assert_array_equal(got[sid][LANG_CLS_FEAT_KEY], ref[sid][LANG_CLS_FEAT_KEY])
        np.testing.assert_array_equal(stored[sid][LANG_CLS_FEAT_KEY], ref[sid][LANG_CLS_FEAT_KEY])


def test_stimuli_dataset_from_csv_equals_jax(tmp_path):
    csv = _stimuli_csv(tmp_path, n=3)
    t = TH.StimuliDataset.from_csv(csv, str(tmp_path))
    j = JH.StimuliDataset.from_csv(csv, str(tmp_path))
    assert (t.img_paths, t.captions, t.root) == (j.img_paths, j.captions, j.root)
    assert t.stimuli_ids == [11, 12]  # the unused row is dropped
    for (ti, tc, tim), (ji, jc, jim) in zip(t.batches(1), j.batches(1)):
        assert (ti, tc) == (ji, jc)
        np.testing.assert_array_equal(np.asarray(tim[0]), np.asarray(jim[0]))
    caps = list(t.batches(2, mode="caption"))
    assert caps == list(j.batches(2, mode="caption"))


@pytest.mark.parametrize("name", ["gabor", "moten"])
def test_bank_extractors_end_to_end_equal_jax(tmp_path, name):
    """The harness-compatible extract_fns (host preprocessing, caption
    rendering, the bank on the device) against the JAX package's."""
    size = 64 if name == "gabor" else 32
    if name == "gabor":
        t_fn, j_fn = TG.make_gabor_extractor(size, device="cpu"), JG.make_gabor_extractor(size)
    else:
        t_fn = TME.make_motion_energy_extractor(size, device="cpu")
        j_fn = JME.make_motion_energy_extractor(size)
    ds = make_dataset(TH.StimuliDataset, tmp_path, n=2)
    (ids, caps, imgs), = ds.batches(2)
    got, ref = t_fn(ids, caps, imgs), j_fn(ids, caps, imgs)
    inputs = {VISION_CLS_FEAT_KEY: np.stack([TG.preprocess_image(im, size) for im in imgs]),
              LANG_CLS_FEAT_KEY: np.stack([TG.render_caption(c, size) for c in caps])}
    for key, x in inputs.items():
        assert isinstance(got[key], np.ndarray)
        scale = (gabor_scale(x, TG._padded_bank(TG.make_gabor_filterbank())) if name == "gabor"
                 else moten_scale(x, *TME.build_spatial_pyramid(size)[:2]))
        _within(got[key], ref[key], scale)


def _stimuli_csv(tmp_path, n=2):
    """stimuli.csv (index = coco id; img_path, caption, used) over seeded PIL
    images, with one unused row."""
    from PIL import Image

    rng = np.random.RandomState(1)
    rows = ["id,img_path,caption,used"]
    for i in range(n):
        name = f"coco_{i}.png"
        Image.fromarray(rng.randint(0, 255, (40 + 8 * i, 56, 3), dtype=np.uint8)).save(
            tmp_path / name)
        rows.append(f"{11 + i},{name},a caption about picture {i},{i < n - 1 or n == 2}")
    path = tmp_path / "stimuli.csv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_cli_moten_pickle_equals_jax_cli(tmp_path, monkeypatch):
    """``extract_features --model moten --device cpu`` on a 2-stimulus csv:
    the same ids and keys as the JAX CLI's pickle, rows within the bar."""
    from multimodal_decoding_tpu.cli import extract_features as jax_cli
    from multimodal_decoding_tpu_torch.cli import extract_features as port_cli

    csv = _stimuli_csv(tmp_path)
    common = ["--model", "moten", "--stim-info-path", csv, "--coco-root", str(tmp_path)]
    port_out, jax_out = str(tmp_path / "port" / "moten.p"), str(tmp_path / "jax" / "moten.p")
    port_cli.main(common + ["--out-path", port_out, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["extract_features"] + common + ["--out-path", jax_out])
    jax_cli.main()
    with open(port_out, "rb") as f:
        got = pickle.load(f)
    with open(jax_out, "rb") as f:
        ref = pickle.load(f)
    assert sorted(got) == sorted(ref) == [11, 12]
    for sid in ref:
        assert got[sid].keys() == ref[sid].keys() == {VISION_CLS_FEAT_KEY, LANG_CLS_FEAT_KEY}
        for key in ref[sid]:
            assert got[sid][key].shape == (1361,)
    ds = TH.StimuliDataset.from_csv(csv, str(tmp_path))
    (ids, caps, imgs), = ds.batches(2)
    inputs = {VISION_CLS_FEAT_KEY: np.stack([TG.preprocess_image(im, 96) for im in imgs]),
              LANG_CLS_FEAT_KEY: np.stack([TG.render_caption(c, 96) for c in caps])}
    sin_b, cos_b, _ = TME.build_spatial_pyramid(96)
    for key, x in inputs.items():
        _within(np.stack([got[s][key] for s in ids]), np.stack([ref[s][key] for s in ids]),
                moten_scale(x, sin_b, cos_b))


def test_cli_defaults_and_no_cpu_fallback(tmp_path, monkeypatch):
    from multimodal_decoding_tpu_torch.cli import extract_features as port_cli

    assert port_cli.get_args(["--model", "gabor"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--model", "gabor", "--stim-info-path", str(tmp_path / "none.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.compute_gabor_feats_batch(np.zeros((1, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TME.motion_energy_features(np.zeros((1, 8, 8), np.float32))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from multimodal_decoding_tpu_torch.utils.profiling import StageTimer, device_trace

    log_dir = str(tmp_path / "trace")
    timer = StageTimer()
    with device_trace(log_dir) as prof:
        with timer.stage("conv"):
            TG.compute_gabor_feats_batch(np.ones((2, 16, 16), np.float32),
                                         TG._padded_bank(TG.make_gabor_filterbank()[:3]),
                                         device="cpu")
    assert prof is not None
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert timer.stages["conv"] > 0 and "conv" in timer.report()
    with device_trace(None) as off:
        assert off is None
