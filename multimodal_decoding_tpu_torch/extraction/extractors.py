"""DNN feature extractors on the GPU: HF torch models and the port's ImageBind.

Rebuild of the per-model extraction CLIs under
the reference's feature_extraction/ (extract_clip_features.py,
extract_base_vision_features.py, extract_base_lm_features.py, ...) as a
registry of builder functions.  Design:

* Builders return ``extract_fn(ids, captions, images) -> {key: [B, D]}``
  closures over (model, processor), so tests can inject tiny random-init
  configs: no weight downloads required.  Every forward runs on the
  model's device (``build_extractor(..., device=)``, default ``cuda``);
  tokens and pixels are made on the host by the processor.
* The families the JAX package runs as Flax models (CLIP, ViT, ResNet,
  BERT, GPT-2, Mistral, Llama) use the HF torch classes with the same
  pooling recipes (``make_clip_extractor`` ... ``make_lm_extractor``);
  ``interop.hf_state_dict_from_flax`` carries Flax weights across.  The
  torch-only families (DINOv2, SigLIP, FLAVA, ViLT, BridgeTower, BLIP-2,
  PaliGemma, VisualBERT) keep their builders; ImageBind is the port's own
  modules (extraction/imagebind.py); fully external models go through
  harness.import_external_features.
* Pooling recipes mirror the reference exactly: CLS token +
  padding-mask-aware mean for LMs (extract_base_lm_features.py:32-44), CLS +
  patch-mean for ViTs (extract_base_vision_features.py:60-68), pooler for
  ResNets (:82-86), contrastive embeds for CLIP (extract_clip_features.py:27-30).

Registry metadata records the reference's batch sizes (SURVEY.md §6) and the
random-init control variants (extract_imagebind_features.py:40-42 pattern —
any model can be built with ``pretrained=False``).  ``transformers`` is
imported only by the builders that need it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from multimodal_decoding_tpu_torch.config import (
    FUSED_CLS_FEAT_KEY,
    FUSED_MEAN_FEAT_KEY,
    LANG_CLS_FEAT_KEY,
    LANG_MEAN_FEAT_KEY,
    VISION_CLS_FEAT_KEY,
    VISION_MEAN_FEAT_KEY,
)
from multimodal_decoding_tpu_torch.device import resolve_device


def masked_mean(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Padding-aware token mean (extract_base_lm_features.py:33-37)."""
    mask = mask[..., None].to(hidden.dtype)
    return (hidden * mask).sum(dim=1) / mask.sum(dim=1)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _to(inputs, device) -> dict:
    """Processor outputs (tensors or arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in dict(inputs).items()}


def _np(t):
    return t.float().cpu().numpy()


# ---------------------------------------------------------------------------
# The JAX package's Flax families, on the HF torch classes
# ---------------------------------------------------------------------------


def make_clip_extractor(model, processor) -> Callable:
    """CLIP contrastive embeds (extract_clip_features.py:19-30)."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(text=list(captions), images=images, return_tensors="pt",
                               padding=True), device)
        with torch.inference_mode():
            out = model(pixel_values=inputs["pixel_values"], input_ids=inputs["input_ids"],
                        attention_mask=inputs["attention_mask"])
        return {
            LANG_CLS_FEAT_KEY: _np(out.text_embeds),
            VISION_CLS_FEAT_KEY: _np(out.image_embeds),
        }

    return extract


def make_vit_extractor(model, processor) -> Callable:
    """ViT CLS + patch-mean (extract_base_vision_features.py:55-68)."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(images=images, return_tensors="pt"), device)
        with torch.inference_mode():
            h = model(pixel_values=inputs["pixel_values"]).last_hidden_state
        return {VISION_CLS_FEAT_KEY: _np(h[:, 0, :]), VISION_MEAN_FEAT_KEY: _np(h[:, 1:, :].mean(dim=1))}

    return extract


def make_resnet_extractor(model, processor) -> Callable:
    """ResNet pooler output (extract_base_vision_features.py:71-86)."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(images=images, return_tensors="pt"), device)
        with torch.inference_mode():
            pooled = model(pixel_values=inputs["pixel_values"]).pooler_output
        return {VISION_MEAN_FEAT_KEY: _np(pooled.squeeze((2, 3)))}

    return extract


def make_lm_extractor(model, tokenizer) -> Callable:
    """LM mask-aware mean + first-token CLS (extract_base_lm_features.py:21-44)."""
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(tokenizer(list(captions), return_tensors="pt", padding=True), device)
        with torch.inference_mode():
            h = model(input_ids=inputs["input_ids"],
                      attention_mask=inputs["attention_mask"]).last_hidden_state
        mean = masked_mean(h, inputs["attention_mask"])
        return {LANG_MEAN_FEAT_KEY: _np(mean), LANG_CLS_FEAT_KEY: _np(h[:, 0, :])}

    return extract


# ---------------------------------------------------------------------------
# The torch-only families (the reference's pooling recipes)
# ---------------------------------------------------------------------------


def make_torch_dual_encoder_extractor(model, processor) -> Callable:
    """SigLIP-style dual encoders."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(text=list(captions), images=images, return_tensors="pt",
                               padding=True), device)
        with torch.no_grad():
            out = model(**inputs)
        return {
            LANG_CLS_FEAT_KEY: out.text_embeds.float().cpu().numpy(),
            VISION_CLS_FEAT_KEY: out.image_embeds.float().cpu().numpy(),
        }

    return extract


def make_torch_fused_extractor(model, processor) -> Callable:
    """ViLT/BridgeTower-style fused encoders: pooler CLS + padding-aware mean
    over fused tokens (extract_vilt_features.py:31-51 recipe)."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(
            images=images, text=list(captions), return_tensors="pt",
            padding=True, truncation=True,
        ), device)
        with torch.no_grad():
            out = model(**inputs)
        h = out.last_hidden_state
        if "attention_mask" in inputs:
            text_mask = inputs["attention_mask"]
            n_extra = h.shape[1] - text_mask.shape[1]
            full_mask = torch.cat(
                [text_mask, torch.ones(h.shape[0], n_extra, dtype=text_mask.dtype,
                                       device=device)], dim=1
            )
        else:
            full_mask = torch.ones(h.shape[:2], dtype=torch.long, device=device)
        me = full_mask.unsqueeze(-1)
        mean = (h * me).sum(1) / me.sum(1)
        cls = out.pooler_output if getattr(out, "pooler_output", None) is not None else h[:, 0]
        return {
            FUSED_MEAN_FEAT_KEY: mean.float().cpu().numpy(),
            FUSED_CLS_FEAT_KEY: cls.float().cpu().numpy(),
        }

    return extract


def make_flava_extractor(model, processor) -> Callable:
    """FLAVA: projected+normalized text/image CLS embeds AND the fused
    multimodal pooler/mean (extract_flava_features.py:34-66).

    The multimodal keys are what distinguishes FLAVA from a plain dual
    encoder: the reference stores four feature families per stimulus."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(text=list(captions), images=images, return_tensors="pt",
                               padding=True), device)
        with torch.no_grad():
            out = model(**inputs)
            text_emb = torch.nn.functional.normalize(
                model.text_projection(out.text_embeddings[:, 0, :]), dim=-1
            )
            image_emb = torch.nn.functional.normalize(
                model.image_projection(out.image_embeddings[:, 0, :]), dim=-1
            )
        fused_cls = out.multimodal_output.pooler_output
        fused_mean = out.multimodal_output.last_hidden_state.mean(dim=1)
        return {
            LANG_CLS_FEAT_KEY: text_emb.float().cpu().numpy(),
            VISION_CLS_FEAT_KEY: image_emb.float().cpu().numpy(),
            FUSED_MEAN_FEAT_KEY: fused_mean.float().cpu().numpy(),
            FUSED_CLS_FEAT_KEY: fused_cls.float().cpu().numpy(),
        }

    return extract


def make_blip2_extractor(model, processor) -> Callable:
    """BLIP-2 Q-Former features via transformers' ITM checkpoint components
    (Blip2ForImageTextRetrieval), reproducing the LAVIS
    blip2_feature_extractor recipe (extract_blip_features.py:29-45):

    * image mode  -> normalized vision_projection of the 32 query outputs;
      CLS = query 0  (LAVIS image_embeds_proj[:, 0, :])
    * text mode   -> normalized text_projection of the text CLS
    * multimodal  -> qformer over [query_tokens; text] cross-attending the
      image; fused mean/CLS over the query positions
    """
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(
            text=list(captions), images=images, return_tensors="pt", padding=True
        ), device)
        pixel_values = inputs["pixel_values"]
        input_ids = inputs["input_ids"]
        attention_mask = inputs.get(
            "attention_mask", torch.ones_like(input_ids)
        )
        with torch.no_grad():
            image_states = model.vision_model(pixel_values=pixel_values)[0]
            img_attn = torch.ones(image_states.shape[:-1], dtype=torch.long, device=device)
            query_tokens = model.query_tokens.expand(image_states.shape[0], -1, -1)
            n_query = query_tokens.shape[1]

            # image mode
            q_out = model.qformer(
                query_embeds=query_tokens,
                encoder_hidden_states=image_states,
                encoder_attention_mask=img_attn,
            )[0]
            image_proj = torch.nn.functional.normalize(
                model.vision_projection(q_out), dim=-1
            )

            # text mode
            text_embeds = model.embeddings(input_ids=input_ids)
            t_out = model.qformer(
                query_embeds=text_embeds, query_length=0, attention_mask=attention_mask
            )[0]
            text_proj = torch.nn.functional.normalize(
                model.text_projection(t_out[:, 0, :]), dim=-1
            )

            # multimodal mode: queries + text attending to the image
            mm_embeds = model.embeddings(input_ids=input_ids, query_embeds=query_tokens)
            query_attn = torch.ones(query_tokens.shape[:-1], dtype=torch.long, device=device)
            mm_out = model.qformer(
                query_embeds=mm_embeds,
                query_length=n_query,
                attention_mask=torch.cat([query_attn, attention_mask], dim=1),
                encoder_hidden_states=image_states,
                encoder_attention_mask=img_attn,
            )[0][:, :n_query, :]

        return {
            LANG_CLS_FEAT_KEY: text_proj.float().cpu().numpy(),
            VISION_CLS_FEAT_KEY: image_proj[:, 0, :].float().cpu().numpy(),
            FUSED_MEAN_FEAT_KEY: mm_out.mean(dim=1).float().cpu().numpy(),
            FUSED_CLS_FEAT_KEY: mm_out[:, 0, :].float().cpu().numpy(),
        }

    return extract


def make_paligemma_extractor(model, processor) -> Callable:
    """PaliGemma: three forward passes — image-only, text-only, fused —
    pooled from the last hidden states (extract_paligemma_features.py:27-95).

    Faithful quirk: the reference zeroes padding positions but divides by the
    FULL sequence length (``.mean(dim=1)`` after zeroing), not the mask sum;
    reproduced here for parity."""
    model.eval()
    device = _model_device(model)
    image_token = "<image>"

    def _zero_pad_mean(hidden, mask):
        hidden = hidden * mask.unsqueeze(-1).to(hidden.dtype)
        return hidden.mean(dim=1)

    def extract(ids, captions, images):
        with torch.no_grad():
            img_inputs = _to(processor(
                text=[image_token for _ in images], images=images, return_tensors="pt"
            ), device)
            h = model(**img_inputs, output_hidden_states=True).hidden_states[-1]
            vision_cls = h[:, 0]
            vision_mean = h.mean(dim=1)

            txt_inputs = _to(processor.tokenizer(
                [f"{processor.tokenizer.bos_token}{c}\n" for c in captions],
                return_token_type_ids=False, return_tensors="pt", padding=True,
            ), device)
            out = model(**txt_inputs, output_hidden_states=True)
            lang_mean = _zero_pad_mean(
                out.hidden_states[-1], txt_inputs["attention_mask"]
            )

            fused_inputs = _to(processor(
                text=list(captions), images=images, return_tensors="pt", padding=True
            ), device)
            out = model(**fused_inputs, output_hidden_states=True)
            fused_mean = _zero_pad_mean(
                out.hidden_states[-1], fused_inputs["attention_mask"]
            )

        return {
            LANG_MEAN_FEAT_KEY: lang_mean.float().cpu().numpy(),
            VISION_MEAN_FEAT_KEY: vision_mean.float().cpu().numpy(),
            VISION_CLS_FEAT_KEY: vision_cls.float().cpu().numpy(),
            FUSED_MEAN_FEAT_KEY: fused_mean.float().cpu().numpy(),
        }

    return extract


def make_torch_lm_extractor(model, tokenizer) -> Callable:
    """Big-LM pooling (the reference runs 7B+ LMs on the CPU,
    extract_base_lm_features.py:63,87-105); same mask-aware mean + CLS
    recipe as make_lm_extractor, on the model's device."""
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(tokenizer(list(captions), return_tensors="pt", padding=True), device)
        with torch.no_grad():
            h = model(**inputs).last_hidden_state
        mask = inputs["attention_mask"].unsqueeze(-1).to(h.dtype)
        mean = (h * mask).sum(dim=1) / mask.sum(dim=1)
        return {
            LANG_MEAN_FEAT_KEY: mean.float().cpu().numpy(),
            LANG_CLS_FEAT_KEY: h[:, 0, :].float().cpu().numpy(),
        }

    return extract


def make_torch_vision_extractor(model, processor) -> Callable:
    """DINOv2-style vision towers (extract_dino_features.py recipe)."""
    model.eval()
    device = _model_device(model)

    def extract(ids, captions, images):
        inputs = _to(processor(images=images, return_tensors="pt"), device)
        with torch.no_grad():
            h = model(**inputs).last_hidden_state
        return {
            VISION_CLS_FEAT_KEY: h[:, 0, :].float().cpu().numpy(),
            VISION_MEAN_FEAT_KEY: h[:, 1:, :].mean(dim=1).float().cpu().numpy(),
        }

    return extract


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass
class ExtractorSpec:
    hf_name: str
    builder: Callable | None  # builder(model, processor) -> extract_fn
    backend: str  # "torch" | "jax" (the in-framework ImageBind) | "external"
    batch_size: int  # reference capacity hint
    model_cls: str = ""  # transformers class names for from_pretrained
    processor_cls: str = ""
    note: str = ""  # provenance / escape-hatch documentation


REGISTRY = {
    # the JAX package's Flax families, on the HF torch classes
    "clip": ExtractorSpec("openai/clip-vit-large-patch14", make_clip_extractor, "torch", 128,
                          "CLIPModel", "CLIPProcessor"),
    "vit-b-16": ExtractorSpec("google/vit-base-patch16-384", make_vit_extractor, "torch", 128,
                              "ViTModel", "ViTImageProcessor"),
    "vit-l-16": ExtractorSpec("google/vit-large-patch16-384", make_vit_extractor, "torch", 128,
                              "ViTModel", "ViTImageProcessor"),
    "vit-h-14": ExtractorSpec("google/vit-huge-patch14-224-in21k", make_vit_extractor, "torch",
                              128, "ViTModel", "ViTImageProcessor"),
    "resnet-18": ExtractorSpec("microsoft/resnet-18", make_resnet_extractor, "torch", 128,
                               "ResNetModel", "AutoImageProcessor"),
    "resnet-50": ExtractorSpec("microsoft/resnet-50", make_resnet_extractor, "torch", 128,
                               "ResNetModel", "AutoImageProcessor"),
    "resnet-152": ExtractorSpec("microsoft/resnet-152", make_resnet_extractor, "torch", 128,
                                "ResNetModel", "AutoImageProcessor"),
    "bert-base-uncased": ExtractorSpec("bert-base-uncased", make_lm_extractor, "torch", 512,
                                       "BertModel", "AutoTokenizer"),
    "bert-large-uncased": ExtractorSpec("bert-large-uncased", make_lm_extractor, "torch", 512,
                                        "BertModel", "AutoTokenizer"),
    "gpt2-small": ExtractorSpec("gpt2", make_lm_extractor, "torch", 512,
                                "GPT2Model", "AutoTokenizer"),
    "gpt2-medium": ExtractorSpec("gpt2-medium", make_lm_extractor, "torch", 512,
                                 "GPT2Model", "AutoTokenizer"),
    "gpt2-large": ExtractorSpec("gpt2-large", make_lm_extractor, "torch", 512,
                                "GPT2Model", "AutoTokenizer"),
    "gpt2-xl": ExtractorSpec("gpt2-xl", make_lm_extractor, "torch", 10,
                             "GPT2Model", "AutoTokenizer"),
    "mistral-7b": ExtractorSpec("mistralai/Mistral-7B-v0.1", make_lm_extractor, "torch", 5,
                                "MistralModel", "AutoTokenizer"),
    "llama2-7b": ExtractorSpec("meta-llama/Llama-2-7b-hf", make_lm_extractor, "torch", 5,
                               "LlamaModel", "AutoTokenizer"),
    "llama2-13b": ExtractorSpec("meta-llama/Llama-2-13b-hf", make_torch_lm_extractor,
                                "torch", 5, "LlamaModel", "AutoTokenizer",
                                note="reference runs 13B on CPU "
                                     "(extract_base_lm_features.py:87-105)"),
    "mixtral-8x7b": ExtractorSpec("mistralai/Mixtral-8x7B-v0.1", make_torch_lm_extractor,
                                  "torch", 5, "MixtralModel", "AutoTokenizer",
                                  note="reference runs Mixtral on CPU "
                                       "(extract_base_lm_features.py:63)"),
    # torch-only families
    "siglip": ExtractorSpec("google/siglip-so400m-patch14-384",
                            make_torch_dual_encoder_extractor, "torch", 128,
                            "SiglipModel", "SiglipProcessor"),
    "dino-base": ExtractorSpec("facebook/dinov2-base", make_torch_vision_extractor, "torch",
                               100, "Dinov2Model", "AutoImageProcessor"),
    "dino-large": ExtractorSpec("facebook/dinov2-large", make_torch_vision_extractor, "torch",
                                100, "Dinov2Model", "AutoImageProcessor"),
    "dino-giant": ExtractorSpec("facebook/dinov2-giant", make_torch_vision_extractor, "torch",
                                100, "Dinov2Model", "AutoImageProcessor"),
    "vilt": ExtractorSpec("dandelin/vilt-b32-mlm", make_torch_fused_extractor, "torch", 10,
                          "ViltModel", "ViltProcessor"),
    "bridgetower": ExtractorSpec("BridgeTower/bridgetower-base",
                                 make_torch_fused_extractor, "torch", 32,
                                 "BridgeTowerModel", "BridgeTowerProcessor"),
    "flava": ExtractorSpec("facebook/flava-full", make_flava_extractor,
                           "torch", 100, "FlavaModel", "FlavaProcessor",
                           note="emits fused multimodal pooler/mean plus projected "
                                "text/image CLS (extract_flava_features.py:34-66)"),
    "blip2": ExtractorSpec("Salesforce/blip2-itm-vit-g", make_blip2_extractor,
                           "torch", 50, "Blip2ForImageTextRetrieval", "Blip2Processor",
                           note="LAVIS blip2_feature_extractor recipe rebuilt on the "
                                "transformers ITM checkpoint (Q-Former image/text/"
                                "multimodal modes); DIFFERENT CHECKPOINT than the "
                                "reference's LAVIS 'pretrain' — recipe-equivalent but "
                                "features are not numerically interchangeable with "
                                "reference pickles"),
    "paligemma2": ExtractorSpec("google/paligemma2-3b-pt-224", make_paligemma_extractor,
                                "torch", 10, "PaliGemmaForConditionalGeneration",
                                "PaliGemmaProcessor",
                                note="three-forward recipe (image-only/text-only/fused); "
                                     "reference uses 8-bit quantization on GPU — full "
                                     "precision here"),
    "visualbert": ExtractorSpec("uclanlp/visualbert-nlvr2-coco-pre", None, "torch", 5,
                                "VisualBertModel", "AutoTokenizer",
                                note="two-stage: build via extraction.visualbert."
                                     "make_visualbert_extractor with cached Mask-RCNN "
                                     "region features (stage-1 box selection in "
                                     "extraction/visualbert.py)"),
    # the in-framework rebuild (extraction/imagebind.py; backend "jax" names
    # it, as in the JAX package's registry): the public ImageBind-Huge
    # architecture as torch modules; pretrained mode loads the official
    # imagebind_huge.pth via the state-dict converter ($IMAGEBIND_CKPT), the
    # random variant needs no files
    "imagebind": ExtractorSpec("imagebind_huge", None, "jax", 10,
                               note="in-framework rebuild (extraction/imagebind.py); "
                                    "pretrained requires the official FAIR checkpoint "
                                    "file — set $IMAGEBIND_CKPT "
                                    "(extract_imagebind_features.py:35-38)"),
    "random-imagebind": ExtractorSpec("imagebind_huge", None, "jax", 10,
                                      note="seeded random-init control "
                                           "(extract_imagebind_features.py:40-42)"),
}


def build_extractor(model_name: str, pretrained: bool = True, dtype=None, device=None):
    """Instantiate (model, processor, extract_fn) for a registry entry, the
    model on ``device`` (default ``cuda``).

    ``pretrained=False`` builds the random-init control variant (the
    reference's 'random-imagebind' / 'Resnet-152-random' pattern).  Requires
    network access (or a local HF cache) for configs/weights; ImageBind's
    random control needs neither.
    """
    spec = REGISTRY[model_name]
    if model_name in ("imagebind", "random-imagebind"):
        from multimodal_decoding_tpu_torch.extraction import imagebind

        params, cfg, extract = imagebind.build_imagebind(
            pretrained=pretrained and model_name == "imagebind",
            cfg=imagebind.ImageBindConfig(), device=device,
        )
        return params, cfg, extract
    if spec.backend == "external":
        raise ValueError(
            f"'{model_name}' has no in-framework forward pass ({spec.note}); "
            "compute features with the upstream repo and load them via "
            "extraction.harness.import_external_features"
        )
    if spec.builder is None:
        raise ValueError(
            f"'{model_name}' needs a special build path: {spec.note}"
        )
    device = resolve_device(device)
    import transformers

    model_cls = getattr(transformers, spec.model_cls)
    proc_cls = getattr(transformers, spec.processor_cls)
    processor = proc_cls.from_pretrained(spec.hf_name)
    if pretrained:
        model = model_cls.from_pretrained(spec.hf_name)
    else:
        cfg = transformers.AutoConfig.from_pretrained(spec.hf_name)
        model = model_cls(cfg)
    model = model.to(device)
    return model, processor, spec.builder(model, processor)
