"""Port parity: the extractor registry, the HF builders and the goldens.

* The registry keeps the JAX package's keys, HF names, batch sizes and notes;
  the Flax classes become the HF torch classes.
* CLIP, ViT, ResNet, BERT and GPT-2: a seeded tiny Flax model runs through
  the JAX package's Flax extractor, and the same weights, carried across by
  ``interop.hf_state_dict_from_flax`` (``strict=True``), through the port's
  torch extractor on the same processor outputs: within atol 2e-5.
* The torch builders (FLAVA, BLIP-2, PaliGemma, ViLT, SigLIP, DINOv2, big-LM,
  VisualBERT) are copies: the same tiny torch model and stub inputs give
  equal outputs in both packages.
* The goldens: the port reproduces every key of
  tests/fixtures/extractor_goldens.npz within the golden test's rtol 2e-4 /
  atol 2e-5 (tests/test_extractor_goldens.py:49); the fixture is read, not
  recomputed.
"""

import os

import numpy as np
import pytest
import torch
import transformers
from flax import traverse_util

from multimodal_decoding_tpu.extraction import extractors as JE
from multimodal_decoding_tpu.extraction import visualbert as JVB
from multimodal_decoding_tpu_torch.config import (
    FUSED_CLS_FEAT_KEY,
    FUSED_MEAN_FEAT_KEY,
    LANG_CLS_FEAT_KEY,
    VISION_CLS_FEAT_KEY,
)
from multimodal_decoding_tpu_torch.extraction import extractors as TE
from multimodal_decoding_tpu_torch.extraction import visualbert as TVB
from multimodal_decoding_tpu_torch.interop import hf_state_dict_from_flax

ATOL = 2e-5
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "extractor_goldens.npz")


def _images(n, size=24):
    from PIL import Image

    rng = np.random.RandomState(0)
    return [Image.fromarray(rng.randint(0, 255, (size, size, 3), dtype=np.uint8))
            for _ in range(n)]


def _tokens(texts, vocab=50, width=None):
    """Deterministic ids and a padding mask (numpy), right-padded."""
    toks = [[sum(map(ord, w)) % (vocab - 1) + 1 for w in t.split()][:8] for t in texts]
    n = width or max(len(t) for t in toks)
    ids = np.zeros((len(toks), n), np.int32)
    mask = np.zeros((len(toks), n), np.int32)
    for i, t in enumerate(toks):
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask


def _pixels(images, size=24):
    return np.stack([np.asarray(im.resize((size, size)), np.float32).transpose(2, 0, 1) / 255.0
                     for im in images])


class NumpyProcessor:
    """Stub processor/tokenizer: numpy outputs, for the Flax and the torch
    extractors alike (the port moves them to the model's device)."""
    pad_token, eos_token = "[PAD]", "[EOS]"

    def __call__(self, text=None, images=None, return_tensors="np", padding=True, **kw):
        out = {}
        if text is not None:
            out["input_ids"], out["attention_mask"] = _tokens(text)
        if images is not None:
            out["pixel_values"] = _pixels(images)
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

FLAX_TO_TORCH = {"FlaxCLIPModel": "CLIPModel", "FlaxViTModel": "ViTModel",
                 "FlaxResNetModel": "ResNetModel", "FlaxBertModel": "BertModel",
                 "FlaxGPT2Model": "GPT2Model", "FlaxMistralModel": "MistralModel",
                 "FlaxLlamaModel": "LlamaModel"}


def test_registry_equals_jax():
    assert list(TE.REGISTRY) == list(JE.REGISTRY)
    for name, j in JE.REGISTRY.items():
        t = TE.REGISTRY[name]
        assert (t.hf_name, t.batch_size, t.processor_cls, t.note) == \
            (j.hf_name, j.batch_size, j.processor_cls, j.note if name != "imagebind" else t.note)
        assert t.model_cls == FLAX_TO_TORCH.get(j.model_cls, j.model_cls), name
        assert t.backend == ("torch" if j.backend == "flax" else j.backend), name
        assert (t.builder is None) == (j.builder is None), name
        if t.builder is not None:
            assert t.builder.__name__ == j.builder.__name__, name
        if t.model_cls:
            assert hasattr(transformers, t.model_cls), t.model_cls


def test_special_build_paths_raise_with_guidance(monkeypatch):
    monkeypatch.delenv("IMAGEBIND_CKPT", raising=False)
    with pytest.raises(ValueError, match="visualbert"):
        TE.build_extractor("visualbert", device="cpu")
    with pytest.raises(FileNotFoundError, match="IMAGEBIND_CKPT"):
        TE.build_extractor("imagebind", device="cpu")


def test_masked_mean_equals_jax():
    rng = np.random.RandomState(3)
    h = rng.randn(3, 5, 4).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.int32)
    np.testing.assert_allclose(TE.masked_mean(torch.as_tensor(h), torch.as_tensor(mask)).numpy(),
                               np.asarray(JE.masked_mean(h, mask)), atol=1e-6)


# ---------------------------------------------------------------------------
# The Flax families: the same weights through both packages
# ---------------------------------------------------------------------------


def _clip():
    cfg = transformers.CLIPConfig.from_text_vision_configs(
        transformers.CLIPTextConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                    num_attention_heads=2, intermediate_size=32,
                                    max_position_embeddings=16, projection_dim=8),
        transformers.CLIPVisionConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                      intermediate_size=32, image_size=24, patch_size=8,
                                      projection_dim=8),
        projection_dim=8)
    return cfg, transformers.FlaxCLIPModel, transformers.CLIPModel, "make_clip_extractor"


def _vit():
    cfg = transformers.ViTConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                 intermediate_size=32, image_size=24, patch_size=8)
    return cfg, transformers.FlaxViTModel, transformers.ViTModel, "make_vit_extractor"


def _resnet():
    cfg = transformers.ResNetConfig(embedding_size=8, hidden_sizes=[8, 16], depths=[1, 1],
                                    layer_type="bottleneck")
    return cfg, transformers.FlaxResNetModel, transformers.ResNetModel, "make_resnet_extractor"


def _bert():
    cfg = transformers.BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=32,
                                  max_position_embeddings=32)
    return cfg, transformers.FlaxBertModel, transformers.BertModel, "make_lm_extractor"


def _gpt2():
    cfg = transformers.GPT2Config(vocab_size=50, n_embd=16, n_layer=2, n_head=2, n_positions=32)
    return cfg, transformers.FlaxGPT2Model, transformers.GPT2Model, "make_lm_extractor"


def _flax_and_torch(family, seed=0):
    """A seeded Flax model and the torch model holding its weights.  The
    batch norms' running statistics are set to seeded values first, so the
    mapping of batch_stats is exercised."""
    cfg, flax_cls, torch_cls, builder = family()
    fm = flax_cls(cfg, seed=seed)
    flat = traverse_util.flatten_dict(fm.params, sep="/")
    rng = np.random.RandomState(seed + 1)
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            flat[k] = (rng.rand(*v.shape) + 0.5 if k.endswith("var")
                       else rng.randn(*v.shape) * 0.1).astype(np.float32)
    fm.params = traverse_util.unflatten_dict(flat, sep="/")
    tm = torch_cls(cfg)
    tm.load_state_dict(hf_state_dict_from_flax(flat), strict=True)
    return fm, tm, builder


@pytest.mark.parametrize("family", [_clip, _vit, _resnet, _bert, _gpt2],
                         ids=lambda f: f.__name__[1:])
def test_flax_family_equals_jax_extractor(family):
    fm, tm, builder = _flax_and_torch(family)
    captions = ["hello world", "a longer caption with more words", "one"]
    images = _images(3)
    ref = getattr(JE, builder)(fm, NumpyProcessor())([1, 2, 3], captions, images)
    got = getattr(TE, builder)(tm, NumpyProcessor())([1, 2, 3], captions, images)
    assert got.keys() == ref.keys()
    for key, v in ref.items():
        assert got[key].dtype == np.float32 and got[key].shape == np.shape(v)
        np.testing.assert_allclose(got[key], np.asarray(v), atol=ATOL, err_msg=key)


def test_hf_state_dict_from_flax_renaming_rules():
    flat = {"params/conv/kernel": np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4),
            "dense/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
            "norm/scale": np.ones(3, np.float32), "embed/embedding": np.zeros((5, 2), np.float32),
            "batch_stats/bn/mean": np.full(4, 2.0, np.float32),
            "batch_stats/bn/var": np.full(4, 3.0, np.float32),
            "logit_scale": np.float32(2.5)}
    sd = hf_state_dict_from_flax(flat)
    assert set(sd) == {"conv.weight", "dense.weight", "norm.weight", "embed.weight",
                       "bn.running_mean", "bn.running_var", "bn.num_batches_tracked",
                       "logit_scale"}
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  flat["params/conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["dense.weight"].numpy(), flat["dense/kernel"].T)
    assert sd["logit_scale"].shape == () and float(sd["logit_scale"]) == 2.5
    assert int(sd["bn.num_batches_tracked"]) == 0


# ---------------------------------------------------------------------------
# The torch-only builders: copies, equal outputs on the same model
# ---------------------------------------------------------------------------


class TorchProcessor:
    """The JAX tests' stub processors in one: torch tensors, fixed widths."""
    pad_token, eos_token, bos_token = "[PAD]", "[EOS]", "<bos>"

    def __init__(self, size=24, width=None, image_token=None, n_img=0):
        self.size, self.width, self.image_token, self.n_img = size, width, image_token, n_img
        self.tokenizer = self
        self.image_seq_length = n_img

    def __call__(self, text=None, images=None, return_tensors="pt", padding=True, **kw):
        out = {}
        if text is not None:
            text = [t.replace("<image>", "x") for t in text]
            ids, mask = _tokens(text, width=self.width)
            ids, mask = torch.as_tensor(ids, dtype=torch.long), torch.as_tensor(mask,
                                                                               dtype=torch.long)
            if self.image_token is not None and images is not None:
                ids = torch.cat([torch.full((len(text), self.n_img), self.image_token), ids], 1)
                mask = torch.cat([torch.ones((len(text), self.n_img), dtype=torch.long), mask], 1)
            out["input_ids"], out["attention_mask"] = ids, mask
            if kw.get("return_token_type_ids") is not False and self.image_token is None:
                out["token_type_ids"] = torch.zeros_like(ids)
        if images is not None:
            out["pixel_values"] = torch.as_tensor(_pixels(images, self.size))
            if self.size == 32:
                out["pixel_mask"] = torch.ones((len(images), 32, 32), dtype=torch.long)
        return out


def _flava():
    tiny = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32)
    cfg = transformers.FlavaConfig(image_config=dict(image_size=24, patch_size=8, **tiny),
                                   text_config=dict(vocab_size=50, max_position_embeddings=16,
                                                    **tiny),
                                   multimodal_config=dict(**tiny), hidden_size=16,
                                   projection_dim=8)
    return transformers.FlavaModel(cfg), TorchProcessor(width=6), "make_flava_extractor", 24


def _blip2():
    cfg = transformers.Blip2Config(
        vision_config=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, image_size=24, patch_size=8),
        qformer_config=dict(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=32,
                            encoder_hidden_size=16, max_position_embeddings=32,
                            use_qformer_text_input=True),
        num_query_tokens=4, image_text_hidden_size=8)
    return (transformers.Blip2ForImageTextRetrieval(cfg), TorchProcessor(width=5),
            "make_blip2_extractor", 24)


def _paligemma():
    img_tok, n_img = 60, 9
    cfg = transformers.PaliGemmaConfig(
        vision_config=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, image_size=24, patch_size=8, projection_dim=16),
        text_config=dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, num_key_value_heads=1, intermediate_size=32,
                         max_position_embeddings=64),
        image_token_index=img_tok, projection_dim=16)
    return (transformers.PaliGemmaForConditionalGeneration(cfg),
            TorchProcessor(image_token=img_tok, n_img=n_img), "make_paligemma_extractor", 24)


def _vilt():
    cfg = transformers.ViltConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                  num_attention_heads=2, intermediate_size=32,
                                  max_position_embeddings=32, image_size=32, patch_size=16)
    return (transformers.ViltModel(cfg), TorchProcessor(size=32, width=6),
            "make_torch_fused_extractor", 32)


def _siglip():
    cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32, max_position_embeddings=16),
        vision_config=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, image_size=24, patch_size=8))
    return (transformers.SiglipModel(cfg), TorchProcessor(width=6),
            "make_torch_dual_encoder_extractor", 24)


def _dino():
    cfg = transformers.Dinov2Config(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                    intermediate_size=32, image_size=24, patch_size=8)
    return transformers.Dinov2Model(cfg), TorchProcessor(), "make_torch_vision_extractor", 24


def _llama():
    cfg = transformers.LlamaConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                   num_attention_heads=2, intermediate_size=32,
                                   max_position_embeddings=32)
    return transformers.LlamaModel(cfg), TorchProcessor(), "make_torch_lm_extractor", 24


@pytest.mark.parametrize("family", [_flava, _blip2, _paligemma, _vilt, _siglip, _dino, _llama],
                         ids=lambda f: f.__name__[1:])
def test_torch_builder_equals_jax_copy(family):
    torch.manual_seed(0)
    model, proc, builder, size = family()
    captions = ["a cat", "two dogs play fetch"]
    images = _images(2, size=size)
    torch.manual_seed(1)  # ViLT draws its patch order (torch.multinomial)
    ref = getattr(JE, builder)(model, proc)([1, 2], captions, images)
    torch.manual_seed(1)
    got = getattr(TE, builder)(model, proc)([1, 2], captions, images)
    assert got.keys() == ref.keys()
    for key, v in ref.items():
        assert np.all(np.isfinite(got[key]))
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_visualbert_two_stage_equals_jax(tmp_path):
    """Stage 1 (box selection, caching) and stage 2 (fused pooling over a
    mixed-count batch) against the JAX package's copies."""
    rng = np.random.RandomState(0)
    boxes = rng.rand(6, 4) * 20
    boxes[:, 2:] += boxes[:, :2]
    scores = rng.rand(6)
    np.testing.assert_array_equal(TVB.nms(boxes, scores, 0.3), JVB.nms(boxes, scores, 0.3))
    probs = rng.dirichlet(np.ones(4), size=30)
    cls_boxes = rng.rand(30, 3, 4) * 50
    cls_boxes[..., 2:] += cls_boxes[..., :2]
    conf = TVB.max_confidences(probs, cls_boxes)
    np.testing.assert_array_equal(conf, JVB.max_confidences(probs, cls_boxes))
    for thr in (0.99, 0.3, 0.01):
        np.testing.assert_array_equal(TVB.select_boxes(conf, thr, 5, 12),
                                      JVB.select_boxes(conf, thr, 5, 12))

    def detector(seed):
        r = np.random.RandomState(seed)

        def run(image):
            b = r.rand(30, 3, 4) * 50
            b[..., 2:] += b[..., :2]
            return r.dirichlet(np.ones(4), size=30), b, r.randn(30, 12)
        return run

    got = TVB.extract_region_features([7, 8], [None, None], detector(1),
                                      cache_path=str(tmp_path / "t" / "c.p"), min_boxes=5,
                                      max_boxes=9)
    ref = JVB.extract_region_features([7, 8], [None, None], detector(1),
                                      cache_path=str(tmp_path / "j" / "c.p"), min_boxes=5,
                                      max_boxes=9)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])

    torch.manual_seed(2)
    cfg = transformers.VisualBertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                        num_attention_heads=2, intermediate_size=32,
                                        visual_embedding_dim=12, max_position_embeddings=64)
    model = transformers.VisualBertModel(cfg)
    regions = {1: rng.randn(7, 12).astype(np.float32), 2: rng.randn(4, 12).astype(np.float32)}
    proc = TorchProcessor()
    ref = JVB.make_visualbert_extractor(model, proc, regions)([1, 2], ["a cat sat", "dogs"], None)
    got = TVB.make_visualbert_extractor(model, proc, regions)([1, 2], ["a cat sat", "dogs"], None)
    for key in (FUSED_MEAN_FEAT_KEY, FUSED_CLS_FEAT_KEY):
        np.testing.assert_array_equal(got[key], ref[key])


# ---------------------------------------------------------------------------
# Goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_goldens():
    """tests/make_extractor_goldens.py's compute_all through the port: the
    same seeded models and fixed inputs, the port's extractors."""
    from multimodal_decoding_tpu_torch.config import FUSED_CLS_FEAT_KEY as FC
    from multimodal_decoding_tpu_torch.extraction import imagebind as IB
    from tests.make_extractor_goldens import fixed_pixels, fixed_text_inputs

    out = {}
    ids, mask = fixed_text_inputs()

    class Fixed:
        def __call__(self, text=None, images=None, **kw):
            return {"input_ids": torch.as_tensor(ids, dtype=torch.long),
                    "attention_mask": torch.as_tensor(mask, dtype=torch.long),
                    "pixel_values": torch.as_tensor(fixed_pixels()),
                    "token_type_ids": torch.zeros(ids.shape, dtype=torch.long)}

    # CLIP and BERT: the fixture's Flax models (seed 0), their weights in torch
    cfg = transformers.CLIPConfig.from_text_vision_configs(
        transformers.CLIPTextConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                    num_attention_heads=2, intermediate_size=32,
                                    max_position_embeddings=16, projection_dim=8),
        transformers.CLIPVisionConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                                      intermediate_size=32, image_size=24, patch_size=8,
                                      projection_dim=8),
        projection_dim=8)
    clip = transformers.CLIPModel(cfg)
    clip.load_state_dict(hf_state_dict_from_flax(traverse_util.flatten_dict(
        transformers.FlaxCLIPModel(cfg, seed=0).params, sep="/")), strict=True)
    o = TE.make_clip_extractor(clip, lambda **kw: {
        k: v for k, v in Fixed()().items() if k != "token_type_ids"})([1, 2], ["a", "b"], None)
    out["clip_text_embeds"], out["clip_image_embeds"] = o[LANG_CLS_FEAT_KEY], o[VISION_CLS_FEAT_KEY]

    bcfg = transformers.BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                                   num_attention_heads=2, intermediate_size=32,
                                   max_position_embeddings=32)
    bert = transformers.BertModel(bcfg)
    bert.load_state_dict(hf_state_dict_from_flax(traverse_util.flatten_dict(
        transformers.FlaxBertModel(bcfg, seed=0).params, sep="/")), strict=True)

    class BertTok(Fixed):
        pad_token = "[PAD]"

    o = TE.make_lm_extractor(bert, BertTok())([1, 2], ["a", "b"], None)
    out["bert_lang_mean"], out["bert_lang_cls"] = o["lang_features_mean"], o[LANG_CLS_FEAT_KEY]

    torch.manual_seed(0)
    tiny = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32)
    flava = transformers.FlavaModel(transformers.FlavaConfig(
        image_config=dict(image_size=24, patch_size=8, **tiny),
        text_config=dict(vocab_size=50, max_position_embeddings=16, **tiny),
        multimodal_config=dict(**tiny), hidden_size=16, projection_dim=8))
    o = TE.make_flava_extractor(flava, lambda **kw: {
        k: v for k, v in Fixed()().items() if k != "token_type_ids"})([1, 2], ["a", "b"], [0, 0])
    out["flava_lang_cls"], out["flava_vision_cls"] = o[LANG_CLS_FEAT_KEY], o[VISION_CLS_FEAT_KEY]
    out["flava_fused_mean"], out["flava_fused_cls"] = o[FUSED_MEAN_FEAT_KEY], o[FC]

    torch.manual_seed(1)
    vilt = transformers.ViltModel(transformers.ViltConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=32, image_size=32, patch_size=16))

    def vilt_proc(images=None, text=None, **kw):
        px = np.random.RandomState(44).rand(len(text), 3, 32, 32).astype(np.float32)
        return {"input_ids": torch.as_tensor(ids, dtype=torch.long),
                "attention_mask": torch.as_tensor(mask, dtype=torch.long),
                "pixel_values": torch.as_tensor(px),
                "pixel_mask": torch.ones((len(text), 32, 32), dtype=torch.long)}

    o = TE.make_torch_fused_extractor(vilt, vilt_proc)([1, 2], ["a", "b"], [None, None])
    out["vilt_fused_mean"], out["vilt_fused_cls"] = o[FUSED_MEAN_FEAT_KEY], o[FC]

    torch.manual_seed(2)
    vb = transformers.VisualBertModel(transformers.VisualBertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, visual_embedding_dim=12, max_position_embeddings=64))
    regions_rng = np.random.RandomState(45)
    regions = {1: regions_rng.randn(5, 12).astype(np.float32),
               2: regions_rng.randn(5, 12).astype(np.float32)}
    o = TVB.make_visualbert_extractor(vb, lambda texts, **kw: Fixed()(), regions)(
        [1, 2], ["a", "b"], None)
    out["visualbert_fused_mean"], out["visualbert_fused_cls"] = o[FUSED_MEAN_FEAT_KEY], o[FC]

    ib_cfg = IB.ImageBindConfig(vision_embed_dim=16, vision_layers=2, vision_heads=2,
                                text_embed_dim=12, text_layers=2, text_heads=2, out_embed_dim=8,
                                image_size=28, patch_size=14, n_frames=2, context_length=10,
                                vocab_size=64)
    model = IB.params_from_torch_state_dict(IB.fake_torch_state_dict(ib_cfg, seed=3), ib_cfg,
                                            device="cpu")
    ib_ids = np.zeros((2, ib_cfg.context_length), np.int32)
    ib_ids[0, :4] = [1, 7, 9, ib_cfg.vocab_size - 1]
    ib_ids[1, :6] = [1, 3, 5, 7, 9, ib_cfg.vocab_size - 1]
    ib_px = np.random.RandomState(46).rand(2, 3, 28, 28).astype(np.float32)
    with torch.inference_mode():
        out["imagebind_lang_cls"] = IB.text_forward(model, ib_cfg, ib_ids).numpy()
        out["imagebind_vision_cls"] = IB.vision_forward(model, ib_cfg, ib_px).numpy()
    return out


GOLDEN_KEYS = [
    "clip_text_embeds", "clip_image_embeds",
    "bert_lang_mean", "bert_lang_cls",
    "flava_lang_cls", "flava_vision_cls", "flava_fused_mean", "flava_fused_cls",
    "vilt_fused_mean", "vilt_fused_cls",
    "visualbert_fused_mean", "visualbert_fused_cls",
    "imagebind_lang_cls", "imagebind_vision_cls",
]


def test_golden_keys_cover_the_fixture(port_goldens):
    assert set(np.load(FIXTURE)) == set(GOLDEN_KEYS) == set(port_goldens)


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_port_reproduces_golden(port_goldens, key):
    np.testing.assert_allclose(port_goldens[key], np.load(FIXTURE)[key], rtol=2e-4, atol=2e-5)
