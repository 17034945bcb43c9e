"""Port parity: ImageBind as torch modules against the JAX package's forward.

The same seeded numpy inputs and official-format state dicts go through
``multimodal_decoding_tpu.extraction.imagebind`` and
``multimodal_decoding_tpu_torch.extraction.imagebind`` at a tiny config.
Forwards agree within atol 2e-5 (the bar tests/test_imagebind.py holds the
JAX forward to against stock torch modules); the random control's weights
are bit-equal to the JAX package's ``init_params`` for the same seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_decoding_tpu.extraction import imagebind as J
from multimodal_decoding_tpu_torch.extraction import imagebind as T
from multimodal_decoding_tpu_torch.interop import imagebind_from_jax_params
from multimodal_decoding_tpu_torch.utils import threefry

ATOL = 2e-5
TINY_KW = dict(
    vision_embed_dim=16, vision_layers=2, vision_heads=2,
    text_embed_dim=12, text_layers=2, text_heads=2,
    out_embed_dim=8, image_size=28, patch_size=14, n_frames=2,
    context_length=10, vocab_size=64,
)
J_TINY, T_TINY = J.ImageBindConfig(**TINY_KW), T.ImageBindConfig(**TINY_KW)


def _stub_tokenizer(texts):
    return [[(sum(map(ord, w)) % 60) + 1 for w in t.split()] for t in texts]


def _pixels(seed, n=3):
    return np.random.RandomState(seed).randn(n, 3, 28, 28).astype(np.float32)


def _ids(seed):
    rng = np.random.RandomState(seed)
    ids = np.zeros((4, T_TINY.context_length), np.int32)
    for i, n in enumerate([3, 5, T_TINY.context_length - 2, 1]):
        ids[i, 0] = J.SOT_TOKEN % T_TINY.vocab_size
        ids[i, 1: 1 + n] = rng.randint(1, T_TINY.vocab_size - 2, n)
        ids[i, 1 + n] = T_TINY.vocab_size - 1  # EOT = highest id
    return ids


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX pytree and the port's modules from one official-format dict."""
    sd = J.fake_torch_state_dict(J_TINY, seed=3)
    return (J.params_from_torch_state_dict(sd, J_TINY),
            T.params_from_torch_state_dict(T.fake_torch_state_dict(T_TINY, seed=3), T_TINY,
                                           device="cpu"))


def _port(fn, *args):
    with torch.inference_mode():
        return fn(*args).numpy()


def test_vision_forward_matches_jax(tiny_models):
    jp, tm = tiny_models
    px = _pixels(0)
    ref = np.asarray(J.vision_forward(jp, J_TINY, jnp.asarray(px)))
    got = _port(T.vision_forward, tm, T_TINY, px)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_text_forward_matches_jax(tiny_models):
    jp, tm = tiny_models
    ids = _ids(1)
    ref = np.asarray(J.text_forward(jp, J_TINY, jnp.asarray(ids)))
    got = _port(T.text_forward, tm, T_TINY, ids)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # post-processing semantics: logit-scaled unit directions
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), T_TINY.logit_scale_init, rtol=1e-4)


def test_imagebind_embed_matches_jax(tiny_models):
    jp, tm = tiny_models
    ids, px = _ids(2), _pixels(2, n=4)
    ref_t, ref_v = J.imagebind_embed(jp, J_TINY, jnp.asarray(ids), jnp.asarray(px))
    with torch.inference_mode():
        got_t, got_v = T.imagebind_embed(tm, T_TINY, ids, px)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=ATOL)


def test_patchify_equals_jax():
    px = _pixels(4, n=2)
    ref = np.asarray(J.patchify(jnp.asarray(px), J_TINY))
    np.testing.assert_array_equal(T.patchify(torch.as_tensor(px), T_TINY).numpy(), ref)


def test_text_eos_selection_uses_argmax_not_last(tiny_models):
    """Two captions of different length select different positions, as in
    the JAX forward."""
    jp, tm = tiny_models
    ids = np.zeros((2, T_TINY.context_length), np.int32)
    ids[0, :3] = [5, 9, T_TINY.vocab_size - 1]
    ids[1, :6] = [5, 9, 2, 7, 4, T_TINY.vocab_size - 1]
    got = _port(T.text_forward, tm, T_TINY, ids)
    assert not np.allclose(got[0], got[1])
    np.testing.assert_allclose(got, np.asarray(J.text_forward(jp, J_TINY, jnp.asarray(ids))),
                               atol=ATOL)


def _jax_leaves_by_port_name(jp, cfg):
    """{port state_dict key: JAX leaf} of every drawn or constant tensor."""
    out = {"vision.cls_token": jp["vision"]["cls_token"], "vision.patch_w": jp["vision"]["patch_w"],
           "vision.pos_embed": jp["vision"]["pos_embed"],
           "vision.head.weight": jp["vision"]["head_w"],
           "text.token_embed": jp["text"]["token_embed"], "text.pos_embed": jp["text"]["pos_embed"],
           "text.head.weight": jp["text"]["head_w"],
           "text.log_logit_scale": jp["text"]["log_logit_scale"]}
    for name, ln in (("vision.pre_ln", jp["vision"]["pre_ln"]),
                     ("vision.head_ln", jp["vision"]["head_ln"]),
                     ("text.head_ln", jp["text"]["head_ln"])):
        out[f"{name}.weight"], out[f"{name}.bias"] = ln["scale"], ln["bias"]
    renames = {"in_proj_w": "attn.in_proj_weight", "in_proj_b": "attn.in_proj_bias",
               "out_proj_w": "attn.out_proj.weight", "out_proj_b": "attn.out_proj.bias",
               "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
               "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}
    for tower in ("vision", "text"):
        for i, blk in enumerate(jp[tower]["blocks"]):
            for jname, tname in renames.items():
                out[f"{tower}.blocks.{i}.{tname}"] = blk[jname]
            for n in ("norm_1", "norm_2"):
                out[f"{tower}.blocks.{i}.{n}.weight"] = blk[n]["scale"]
                out[f"{tower}.blocks.{i}.{n}.bias"] = blk[n]["bias"]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_bit_equal_to_jax(seed):
    """The random control: every weight the JAX package's init_params draws
    for the same seed, bit for bit (ROADMAP C10's bar is >= 99.9% bit-equal
    and <= 4 ulp; at this config all are equal)."""
    ref = _jax_leaves_by_port_name(J.init_params(jax.random.PRNGKey(seed), J_TINY), J_TINY)
    got = {k: v.numpy() for k, v in T.init_params(threefry.prng_key(seed), T_TINY,
                                                  device="cpu").state_dict().items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.int32), v.view(np.int32), err_msg=k)


@pytest.mark.parametrize("start,stop", [(0, 1), (123, 1999), (2995, 3000)])
def test_normal_flat_is_a_slice_of_the_draw(start, stop):
    """threefry.normal_flat (the chip phase's weight sample) gives elements
    start..stop of any draw from the key, as jax.random.normal does."""
    key = threefry.split(threefry.prng_key(9), 4)[2]
    got = threefry.normal_flat(key, start, stop)
    ref = np.asarray(jax.random.normal(jnp.asarray(key), (3, 1000))).ravel()[start:stop]
    assert got.dtype == np.float32 and got.shape == (stop - start,)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_random_control_extractor_matches_jax(monkeypatch):
    """build_imagebind(pretrained=False, seed=7): the schema, a fixed control
    network (same seed -> same weights), features equal to the JAX package's
    random-imagebind on the same images and captions.  The vocabulary is the
    real one, so SOT/EOT (49406/49407) index real rows.  Both extractors get
    the port's pixels: at 40 x 32 the JAX package crops one column off the
    published transform (``test_host_preprocessing_equals_jax``)."""
    from PIL import Image

    from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY

    monkeypatch.setattr(J, "preprocess_images", T.preprocess_images)
    kw = dict(TINY_KW, vocab_size=49408)
    t_cfg, j_cfg = T.ImageBindConfig(**kw), J.ImageBindConfig(**kw)
    params, cfg, extract = T.build_imagebind(pretrained=False, cfg=t_cfg, seed=7,
                                             tokenizer=_stub_tokenizer, device="cpu")
    _, _, j_extract = J.build_imagebind(pretrained=False, cfg=j_cfg, seed=7,
                                        tokenizer=_stub_tokenizer)
    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 255, (32, 40, 3), dtype=np.uint8))
              for _ in range(2)]
    captions = ["a dog runs", "blue sky"]
    out = extract(["c1", "c2"], captions, images)
    ref = j_extract(["c1", "c2"], captions, images)
    for key in (LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY):
        assert out[key].shape == (2, T_TINY.out_embed_dim) and out[key].dtype == np.float32
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), atol=ATOL, err_msg=key)
    params2, _, _ = T.build_imagebind(pretrained=False, cfg=t_cfg, seed=7, device="cpu")
    assert torch.equal(params.text.token_embed, params2.text.token_embed)


def test_out_of_vocabulary_ids_raise_where_jax_clamps(tiny_models):
    """A divergence by design: the JAX gather clamps an id past the
    vocabulary to its last row; the port raises (ROADMAP C13)."""
    jp, tm = tiny_models
    ids = _ids(8)
    wild = ids.copy()
    wild[:, 0] = J.SOT_TOKEN
    clamped = ids.copy()
    clamped[:, 0] = T_TINY.vocab_size - 1
    np.testing.assert_array_equal(np.asarray(J.text_forward(jp, J_TINY, jnp.asarray(wild))),
                                  np.asarray(J.text_forward(jp, J_TINY, jnp.asarray(clamped))))
    with pytest.raises(IndexError):
        _port(T.text_forward, tm, T_TINY, wild)


def _published_pixels(images, size: int) -> np.ndarray:
    """ImageBind's ``load_and_transform_vision_data`` with PIL: torchvision's
    ``Resize(size, BICUBIC)`` (short side to ``size``, the long side
    ``int(size * long / short)``), ``CenterCrop(size)`` (offsets
    ``int(round((n - size) / 2.0))``), ``ToTensor`` and CLIP's ``Normalize``."""
    from PIL import Image

    out = []
    for img in images:
        w, h = img.size
        short, long = (w, h) if w <= h else (h, w)
        new_long = int(size * long / short)
        new_w, new_h = (size, new_long) if w <= h else (new_long, size)
        img = img.resize((new_w, new_h), Image.BICUBIC)
        top, left = int(round((new_h - size) / 2.0)), int(round((new_w - size) / 2.0))
        x = np.asarray(img.crop((left, top, left + size, top + size)), np.float32) / 255.0
        x = (x - np.array(T.IMAGE_MEAN)) / np.array(T.IMAGE_STD)
        out.append(x.astype(np.float32).transpose(2, 0, 1))
    return np.stack(out)


@pytest.mark.parametrize("width,height,size,jax_agrees", [
    (30, 40, 28, True),  # 37.33 -> 37 either way, margin 9: // 2 and round agree
    (45, 31, 28, False),  # 40.65: 41 against 40
    (640, 480, 224, False),  # COCO: 299 against 298
    (480, 640, 224, False),
    (640, 427, 224, False),  # 336 against 335
])
def test_host_preprocessing_equals_jax(width, height, size, jax_agrees):
    """The port's transform is ImageBind's published one, bit for bit; the
    JAX package's (a rounded long side, a floored crop offset) is bit-equal
    to it only where the two arithmetics agree, and differs elsewhere, by
    design (the JAX package is not edited).  The tokenizer stays the JAX
    package's."""
    from PIL import Image

    rng = np.random.RandomState(5)
    t_cfg = T.ImageBindConfig(**dict(TINY_KW, image_size=size))
    j_cfg = J.ImageBindConfig(**dict(TINY_KW, image_size=size))
    pil = Image.fromarray(rng.randint(0, 255, (height, width, 3), dtype=np.uint8))
    unit = rng.rand(height, width, 3)  # a float image in [0, 1], as the extractors take it
    images = [pil, unit]
    published = _published_pixels([pil, Image.fromarray((unit * 255).astype(np.uint8))], size)
    got = T.preprocess_images(images, t_cfg)
    np.testing.assert_array_equal(got, published)
    jax_pixels = J.preprocess_images(images, j_cfg)
    if jax_agrees:
        np.testing.assert_array_equal(got, jax_pixels)
    else:
        assert not np.array_equal(got, jax_pixels)
    caps = ["a b c d e f g h i j k l", "x"]
    np.testing.assert_array_equal(T.clip_tokenize(caps, T_TINY, _stub_tokenizer),
                                  J.clip_tokenize(caps, J_TINY, _stub_tokenizer))


def test_pretrained_without_checkpoint_raises(monkeypatch):
    monkeypatch.delenv("IMAGEBIND_CKPT", raising=False)
    with pytest.raises(FileNotFoundError, match="IMAGEBIND_CKPT"):
        T.build_imagebind(pretrained=True, cfg=T_TINY, checkpoint_path=None, device="cpu")


def test_checkpoint_roundtrip(tmp_path, tiny_models):
    """torch.save -> build_imagebind(pretrained=True) == direct conversion."""
    _, tm = tiny_models
    sd = T.fake_torch_state_dict(T_TINY, seed=3)
    path = str(tmp_path / "imagebind_tiny.pth")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    loaded, _, _ = T.build_imagebind(pretrained=True, cfg=T_TINY, checkpoint_path=path,
                                     tokenizer=lambda texts: [[1] for _ in texts], device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_manifest_and_fake_state_dict_equal_jax():
    assert T.expected_state_dict_manifest(T_TINY) == J.expected_state_dict_manifest(J_TINY)
    assert T.STATE_DICT_BUFFER_WHITELIST == J.STATE_DICT_BUFFER_WHITELIST
    a, b = T.fake_torch_state_dict(T_TINY, seed=4), J.fake_torch_state_dict(J_TINY, seed=4)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_state_dict_validation_drift_fails_loudly():
    """The converter validates its full key map up front: missing keys, shape
    mismatches, and silently-ignored tower keys all raise with explicit
    lists; out-of-scope modalities are ignored (the JAX package's cases)."""
    sd = T.fake_torch_state_dict(T_TINY, seed=5)
    T.validate_state_dict(sd, T_TINY)

    ok = dict(sd)
    ok["modality_trunks.audio.blocks.0.attn.in_proj_weight"] = np.zeros((3, 1))
    ok["modality_preprocessors.text.mask"] = np.zeros((4, 4))  # whitelisted buffer
    ok["modality_postprocessors.text.1.log_logit_scale"] = np.zeros(1, np.float32)
    T.validate_state_dict(ok, T_TINY)
    T.params_from_torch_state_dict(ok, T_TINY, device="cpu")

    broken = dict(sd)
    del broken["modality_heads.text.proj.1.weight"]
    with pytest.raises(ValueError, match="missing: modality_heads.text.proj.1.weight"):
        T.validate_state_dict(broken, T_TINY)
    broken = dict(sd)
    broken["modality_heads.vision.2.weight"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch: modality_heads.vision.2"):
        T.validate_state_dict(broken, T_TINY)
    broken = dict(sd)
    broken["modality_trunks.vision.blocks.0.attn.qkv.weight"] = broken.pop(
        "modality_trunks.vision.blocks.0.attn.in_proj_weight")
    with pytest.raises(ValueError, match="unconsumed vision/text-tower keys"):
        T.validate_state_dict(broken, T_TINY)
    broken = dict(sd)
    del broken["modality_preprocessors.vision.cls_token"]
    with pytest.raises(ValueError, match="missing"):
        T.params_from_torch_state_dict(broken, T_TINY, device="cpu")


def test_imagebind_from_jax_params():
    """The JAX pytree (as numpy) carried across: weights bit-equal, forwards
    within the bar."""
    jp = J.init_params(jax.random.PRNGKey(11), J_TINY)
    tm = imagebind_from_jax_params(jax.tree_util.tree_map(np.asarray, jp), T_TINY, device="cpu")
    ref = _jax_leaves_by_port_name(jp, J_TINY)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    ids, px = _ids(6), _pixels(6)
    np.testing.assert_allclose(_port(T.text_forward, tm, T_TINY, ids),
                               np.asarray(J.text_forward(jp, J_TINY, jnp.asarray(ids))), atol=ATOL)
    np.testing.assert_allclose(_port(T.vision_forward, tm, T_TINY, px),
                               np.asarray(J.vision_forward(jp, J_TINY, jnp.asarray(px))),
                               atol=ATOL)


def test_registry_builds_random_imagebind(monkeypatch):
    from multimodal_decoding_tpu_torch.extraction.extractors import build_extractor

    # the huge config is too big for a unit test: patch the builder's default cfg
    monkeypatch.setattr(T, "ImageBindConfig", lambda: T_TINY)
    params, cfg, extract = build_extractor("random-imagebind", device="cpu")
    assert cfg is T_TINY and callable(extract) and isinstance(params, T.ImageBind)
    assert params.vision.patch_w.device.type == "cpu"


def test_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_imagebind(pretrained=False, cfg=T_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.params_from_torch_state_dict(T.fake_torch_state_dict(T_TINY), T_TINY)
