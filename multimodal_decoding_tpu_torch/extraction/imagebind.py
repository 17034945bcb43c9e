"""ImageBind-Huge as torch modules: the vision and text towers on one GPU.

The reference extracts ImageBind features through the FAIR model
(the reference's feature_extraction/extract_imagebind_features.py:35-42,
pretrained and the random-init control).  This module rebuilds its two
towers as ``nn.Module``s, the same architecture and semantics as the JAX
package's functional forward:

* ``ImageBindVision``: ViT-H/14 over 2-frame padded "video" patches (the
  Conv3d stem as a reshape and a matmul), CLS, pre-LN, 32 pre-norm blocks,
  head LN on token 0, a linear head, unit norm;
* ``ImageBindText``: the CLIP-style causal tower (causal -inf mask over the
  full padded context, EOS at ``argmax(ids)``), head LN, a linear head, unit
  norm times ``clip(exp(log_logit_scale), max=100)``;
* ``init_params(rng, cfg)``: the seeded random-init control
  ('random-imagebind'), drawn as the JAX package draws it: the same
  Threefry key splits and ``jax.random.normal`` bits
  (``utils/threefry.normal_torch``), so a seed gives the JAX package's
  control network;
* ``params_from_torch_state_dict(sd, cfg)``: the official
  ``imagebind_huge.pth`` key names into these modules, validated up front
  (missing keys, shape mismatches and unconsumed tower keys all raise).

Attention is the JAX function's formula: ``q @ k^T`` times the scale, plus
the mask, softmax, ``@ v`` (no fused attention: its backends reorder the
softmax).  LayerNorm eps is 1e-6; GELU is the exact erf form.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.utils import threefry
from multimodal_decoding_tpu_torch.utils.profiling import count, span

# CLIP BPE special tokens (ImageBind SimpleTokenizer): EOS has the highest
# id, which is what makes the argmax EOS selection correct.
SOT_TOKEN = 49406
EOT_TOKEN = 49407

# load_and_transform_vision_data normalization constants (CLIP's)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

MAX_LOGIT_SCALE = 100.0
LN_EPS = 1e-6


@dataclass(frozen=True)
class ImageBindConfig:
    """imagebind_huge defaults; shrink everything for tests."""

    vision_embed_dim: int = 1280
    vision_layers: int = 32
    vision_heads: int = 16
    text_embed_dim: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    out_embed_dim: int = 1024
    image_size: int = 224
    patch_size: int = 14
    n_frames: int = 2  # PadIm2Video repeats stills to 2 frames
    context_length: int = 77
    vocab_size: int = 49408
    logit_scale_init: float = 14.2857  # 1 / 0.07
    mlp_ratio: float = 4.0

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.n_frames * self.patch_size ** 2


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _Attention(nn.Module):
    """torch.nn.MultiheadAttention's parameters: packed q,k,v rows + out_proj."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        b, l, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1)
        q, k, v = (t.reshape(b, l, self.heads, d // self.heads).transpose(1, 2)
                   for t in (q, k, v))
        logits = q @ k.transpose(-2, -1) * ((d // self.heads) ** -0.5)
        if mask is not None:
            logits = logits + mask
        out = logits.softmax(dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    """BlockWithMasking: pre-norm attention + pre-norm exact-GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim, heads)
        self.norm_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, mask=None):
        x = x + self.attn(self.norm_1(x), mask)
        return x + self.mlp(self.norm_2(x))


def patchify(pixel_values: torch.Tensor, cfg: ImageBindConfig) -> torch.Tensor:
    """[B, 3, H, W] images -> [B, n_patches, 3*T*p*p] flattened patch stack.

    PadIm2Video('repeat', 2) + Conv3d(kernel=stride=(2, p, p)) collapses to a
    reshape + matmul because stills are repeated to exactly the temporal
    kernel size; the flattened axis order (c, t, ph, pw) matches the Conv3d
    weight layout the converter flattens.
    """
    b, c, h, w = pixel_values.shape
    p = cfg.patch_size
    x = pixel_values.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    x = x.unsqueeze(4).expand(b, h // p, w // p, c, cfg.n_frames, p, p)
    return x.reshape(b, (h // p) * (w // p), c * cfg.n_frames * p * p)


class ImageBindVision(nn.Module):
    """VISION branch -> unit-normalized [B, out_embed_dim] embeddings."""

    def __init__(self, cfg: ImageBindConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.vision_embed_dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.patch_w = nn.Parameter(torch.empty(d, cfg.patch_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.n_patches + 1, d))
        self.pre_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            _Block(d, cfg.vision_heads, cfg.mlp_ratio) for _ in range(cfg.vision_layers))
        self.head_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.out_embed_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        tokens = patchify(pixel_values, self.cfg) @ self.patch_w.T
        cls = self.cls_token.expand(tokens.shape[0], 1, tokens.shape[-1])
        x = self.pre_ln(torch.cat([cls, tokens], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        x = self.head(self.head_ln(x[:, 0]))
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ImageBindText(nn.Module):
    """TEXT branch -> logit-scaled unit-direction [B, out_embed_dim] embeds.

    Faithful quirks: causal-only attention over the full padded context (the
    FAIR model never masks padding), EOS position = argmax(token id).
    """

    def __init__(self, cfg: ImageBindConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.text_embed_dim
        self.token_embed = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.context_length, d))
        self.blocks = nn.ModuleList(
            _Block(d, cfg.text_heads, cfg.mlp_ratio) for _ in range(cfg.text_layers))
        self.head_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.out_embed_dim, bias=False)
        self.log_logit_scale = nn.Parameter(torch.empty(()))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        ids = input_ids.to(device=self.token_embed.device, dtype=torch.long)
        x = self.token_embed[ids] + self.pos_embed
        l = self.cfg.context_length
        causal = torch.full((l, l), float("-inf"), dtype=x.dtype, device=x.device).triu_(1)
        for blk in self.blocks:
            x = blk(x, causal)
        x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        x = self.head(self.head_ln(x))
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return self.log_logit_scale.exp().clamp(max=MAX_LOGIT_SCALE) * x


class ImageBind(nn.Module):
    """Both towers (the reference's model(inputs) dict, TEXT + VISION)."""

    def __init__(self, cfg: ImageBindConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = ImageBindVision(cfg)
        self.text = ImageBindText(cfg)

    def forward(self, input_ids, pixel_values):
        return self.text(input_ids), self.vision(pixel_values)


def _empty_model(cfg: ImageBindConfig, device) -> ImageBind:
    """The modules with uninitialised storage on ``device`` (no default init:
    at full width that would be ~1e9 wasted draws)."""
    with torch.device("meta"):
        model = ImageBind(cfg)
    return model.to_empty(device=resolve_device(device)).eval()


def vision_forward(params: ImageBind, cfg: ImageBindConfig, pixel_values) -> torch.Tensor:
    """VISION branch of ``params`` (an ``ImageBind``) on its device."""
    return params.vision(torch.as_tensor(pixel_values, device=params.vision.patch_w.device))


def text_forward(params: ImageBind, cfg: ImageBindConfig, input_ids) -> torch.Tensor:
    """TEXT branch of ``params`` (an ``ImageBind``) on its device."""
    return params.text(torch.as_tensor(input_ids))


def imagebind_embed(params: ImageBind, cfg: ImageBindConfig, input_ids, pixel_values):
    """Both branches: (text embeds, vision embeds).

    Both inputs are copied to the device before either tower is queued, and
    the vision tower goes first.  A blocking copy of host pixels between the
    towers would hold the host until the text tower had drained; queued
    after the vision tower, the text tower's short kernels launch while the
    device is still busy.
    """
    device = params.vision.patch_w.device
    pixel_values = torch.as_tensor(pixel_values, device=device)
    input_ids = torch.as_tensor(input_ids, device=device)
    vision = vision_forward(params, cfg, pixel_values)
    return text_forward(params, cfg, input_ids), vision


# ---------------------------------------------------------------------------
# The random control: the JAX package's init_params, key for key
# ---------------------------------------------------------------------------


def _normal(key, shape, scale, device) -> torch.Tensor:
    """``jax.random.normal(key, shape) * scale`` in float32 on ``device``."""
    return threefry.normal_torch(key, shape, device) * float(np.float32(scale))


def _init_block(blk: _Block, key, dim: int, mlp_dim: int, device) -> None:
    ks = threefry.split(key, 4)
    s = dim ** -0.5
    for ln in (blk.norm_1, blk.norm_2):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    blk.attn.in_proj_weight.copy_(_normal(ks[0], (3 * dim, dim), s, device))
    blk.attn.in_proj_bias.zero_()
    blk.attn.out_proj.weight.copy_(_normal(ks[1], (dim, dim), s, device))
    blk.attn.out_proj.bias.zero_()
    blk.mlp.fc1.weight.copy_(_normal(ks[2], (mlp_dim, dim), s, device))
    blk.mlp.fc1.bias.zero_()
    blk.mlp.fc2.weight.copy_(_normal(ks[3], (dim, mlp_dim), mlp_dim ** -0.5, device))
    blk.mlp.fc2.bias.zero_()


@torch.no_grad()
def init_params(rng, cfg: ImageBindConfig, device=None) -> ImageBind:
    """Seeded random init, the 'random-imagebind' control network.

    ``rng`` is a JAX key's data (``threefry.prng_key(seed)``); every tensor is
    the JAX package's ``init_params(jax.random.PRNGKey(seed), cfg)`` draw,
    made on ``device`` (default ``cuda``).
    """
    device = resolve_device(device)
    model = _empty_model(cfg, device)
    v, t = model.vision, model.text
    kv, kt, kproj = threefry.split(np.asarray(rng, np.uint32), 3)
    d_v, d_t = cfg.vision_embed_dim, cfg.text_embed_dim
    kvs = threefry.split(kv, cfg.vision_layers + 3)
    kts = threefry.split(kt, cfg.text_layers + 2)
    v.cls_token.zero_()
    v.patch_w.copy_(_normal(kvs[0], (d_v, cfg.patch_dim), cfg.patch_dim ** -0.5, device))
    v.pos_embed.copy_(_normal(kvs[1], (1, cfg.n_patches + 1, d_v), 0.02, device))
    for i, blk in enumerate(v.blocks):
        _init_block(blk, kvs[2 + i], d_v, int(d_v * cfg.mlp_ratio), device)
    v.head.weight.copy_(_normal(kvs[-1], (cfg.out_embed_dim, d_v), d_v ** -0.5, device))
    t.token_embed.copy_(_normal(kts[0], (cfg.vocab_size, d_t), 0.02, device))
    t.pos_embed.copy_(_normal(kts[1], (1, cfg.context_length, d_t), 0.01, device))
    for i, blk in enumerate(t.blocks):
        _init_block(blk, kts[2 + i], d_t, int(d_t * cfg.mlp_ratio), device)
    t.head.weight.copy_(_normal(kproj, (cfg.out_embed_dim, d_t), d_t ** -0.5, device))
    for ln in (v.pre_ln, v.head_ln, t.head_ln):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    t.log_logit_scale.copy_(torch.log(torch.tensor(cfg.logit_scale_init, dtype=torch.float32)))
    return model


# ---------------------------------------------------------------------------
# The official checkpoint's key names
# ---------------------------------------------------------------------------


def expected_state_dict_manifest(cfg: ImageBindConfig) -> dict:
    """{key: shape} of every official-checkpoint tensor the converter reads.

    The single source of truth for key-map drift detection:
    ``fake_torch_state_dict`` builds its offline test dicts from this table
    and ``validate_state_dict`` checks a real checkpoint against it.
    Iteration order is load-bearing for ``fake_torch_state_dict`` seeding:
    append only.
    """
    d_v, d_t = cfg.vision_embed_dim, cfg.text_embed_dim
    man = {
        "modality_preprocessors.vision.cls_token": (1, 1, d_v),
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight":
            (d_v, 3, cfg.n_frames, cfg.patch_size, cfg.patch_size),
        "modality_preprocessors.vision.pos_embedding_helper.pos_embed":
            (1, cfg.n_patches + 1, d_v),
        "modality_preprocessors.text.token_embedding.weight":
            (cfg.vocab_size, d_t),
        "modality_preprocessors.text.pos_embed": (1, cfg.context_length, d_t),
        "modality_trunks.vision.pre_transformer_layer.0.weight": (d_v,),
        "modality_trunks.vision.pre_transformer_layer.0.bias": (d_v,),
    }
    for tower, d, n_layers in (("vision", d_v, cfg.vision_layers),
                               ("text", d_t, cfg.text_layers)):
        mlp = int(d * cfg.mlp_ratio)
        for i in range(n_layers):
            p = f"modality_trunks.{tower}.blocks.{i}"
            man[f"{p}.attn.in_proj_weight"] = (3 * d, d)
            man[f"{p}.attn.in_proj_bias"] = (3 * d,)
            man[f"{p}.attn.out_proj.weight"] = (d, d)
            man[f"{p}.attn.out_proj.bias"] = (d,)
            man[f"{p}.norm_1.weight"] = (d,)
            man[f"{p}.norm_1.bias"] = (d,)
            man[f"{p}.norm_2.weight"] = (d,)
            man[f"{p}.norm_2.bias"] = (d,)
            man[f"{p}.mlp.fc1.weight"] = (mlp, d)
            man[f"{p}.mlp.fc1.bias"] = (mlp,)
            man[f"{p}.mlp.fc2.weight"] = (d, mlp)
            man[f"{p}.mlp.fc2.bias"] = (d,)
    man["modality_heads.vision.0.weight"] = (d_v,)
    man["modality_heads.vision.0.bias"] = (d_v,)
    man["modality_heads.vision.2.weight"] = (cfg.out_embed_dim, d_v)
    man["modality_heads.text.proj.0.weight"] = (d_t,)
    man["modality_heads.text.proj.0.bias"] = (d_t,)
    man["modality_heads.text.proj.1.weight"] = (cfg.out_embed_dim, d_t)
    man["modality_postprocessors.text.1.log_logit_scale"] = ()
    return man


#: Vision/text-tower state-dict entries that legitimately carry no weight the
#: forward needs: registered buffers (the text causal mask is rebuilt in
#: ``ImageBindText.forward``).  Anything ELSE unconsumed inside the towers is
#: key-map drift and validate_state_dict raises on it.
STATE_DICT_BUFFER_WHITELIST = (
    "modality_preprocessors.text.mask",
)

#: Prefixes of the two towers this module rebuilds.  Keys outside them
#: (audio/depth/thermal/imu modalities of the full checkpoint) are out of
#: scope and ignored, as in the reference's TEXT/VISION-only usage.
_TOWER_PREFIXES = (
    "modality_preprocessors.vision.", "modality_preprocessors.text.",
    "modality_trunks.vision.", "modality_trunks.text.",
    "modality_heads.vision.", "modality_heads.text.",
    "modality_postprocessors.text.",
)

#: official key prefix -> the port's module key prefix (first match wins)
_KEY_RENAMES = (
    ("modality_preprocessors.vision.cls_token", "vision.cls_token"),
    ("modality_preprocessors.vision.rgbt_stem.proj.1.weight", "vision.patch_w"),
    ("modality_preprocessors.vision.pos_embedding_helper.pos_embed", "vision.pos_embed"),
    ("modality_preprocessors.text.token_embedding.weight", "text.token_embed"),
    ("modality_preprocessors.text.pos_embed", "text.pos_embed"),
    ("modality_trunks.vision.pre_transformer_layer.0.", "vision.pre_ln."),
    ("modality_trunks.vision.blocks.", "vision.blocks."),
    ("modality_trunks.text.blocks.", "text.blocks."),
    ("modality_heads.vision.0.", "vision.head_ln."),
    ("modality_heads.vision.2.", "vision.head."),
    ("modality_heads.text.proj.0.", "text.head_ln."),
    ("modality_heads.text.proj.1.", "text.head."),
    ("modality_postprocessors.text.1.log_logit_scale", "text.log_logit_scale"),
)


def _port_key(key: str) -> str:
    for old, new in _KEY_RENAMES:
        if key.startswith(old):
            return new + key[len(old):]
    raise KeyError(key)


def _shape(v) -> tuple:
    return tuple(int(s) for s in (v.shape if hasattr(v, "shape") else np.shape(v)))


def validate_state_dict(sd: dict, cfg: ImageBindConfig) -> None:
    """Fail loudly on key-map drift between ``sd`` and this module.

    Raises ValueError listing (a) expected keys missing from ``sd``,
    (b) shape mismatches, and (c) vision/text-tower keys in ``sd`` that the
    converter would silently ignore (modulo the documented buffer
    whitelist).  Scalar-vs-[1] layouts are tolerated for the logit scale
    (the converter reshapes it).
    """
    man = expected_state_dict_manifest(cfg)
    problems = []
    for k, shape in man.items():
        if k not in sd:
            problems.append(f"missing: {k} {shape}")
            continue
        got = _shape(sd[k])
        if got != shape and not (
            k == "modality_postprocessors.text.1.log_logit_scale"
            and int(np.prod(got, dtype=np.int64)) == 1
        ):
            problems.append(f"shape mismatch: {k} expected {shape}, got {got}")
    unconsumed = [
        k for k in sd
        if k.startswith(_TOWER_PREFIXES)
        and k not in man
        and k not in STATE_DICT_BUFFER_WHITELIST
    ]
    if unconsumed:
        problems.append(
            "unconsumed vision/text-tower keys (key-map drift? if these are "
            "parameter-free buffers, extend STATE_DICT_BUFFER_WHITELIST): "
            + ", ".join(sorted(unconsumed)[:20])
        )
    if problems:
        raise ValueError(
            "ImageBind state dict does not match the converter's key map:\n  "
            + "\n  ".join(problems[:40])
        )


@torch.no_grad()
def params_from_torch_state_dict(sd: dict, cfg: ImageBindConfig, device=None) -> ImageBind:
    """Official imagebind_huge.pth naming (tensors or numpy arrays) -> the
    port's ``ImageBind`` on ``device`` (default ``cuda``).

    Key map (FAIR ImageBind module tree):
      modality_preprocessors.vision.{cls_token, rgbt_stem.proj.1.weight,
        pos_embedding_helper.pos_embed}
      modality_preprocessors.text.{token_embedding.weight, pos_embed}
      modality_trunks.vision.pre_transformer_layer.0.{weight,bias}
      modality_trunks.{vision,text}.blocks.N.{attn.*, norm_1, norm_2, mlp.*}
      modality_heads.vision.{0: LayerNorm, 2: Linear}
      modality_heads.text.proj.{0: LayerNorm, 1: Linear}
      modality_postprocessors.text.1.log_logit_scale

    The full key map is validated first (``validate_state_dict``), and the
    modules load with ``strict=True``.  The Conv3d stem [D, 3, T, p, p] with
    stride == kernel is a matmul over flattened (c, t, ph, pw) patches.
    """
    validate_state_dict(sd, cfg)
    model = _empty_model(cfg, device)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    port_sd = {}
    for key in expected_state_dict_manifest(cfg):
        name, v = _port_key(key), sd[key]
        t = v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
        port_sd[name] = t.reshape(shapes[name])
    model.load_state_dict(port_sd, strict=True)
    return model


def fake_torch_state_dict(cfg: ImageBindConfig, seed: int = 0) -> dict:
    """Official-format random state dict (numpy), for offline converter and
    parity tests: every key/shape the converter consumes, none it doesn't,
    drawn in manifest order (the JAX package's dict for the same seed)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in expected_state_dict_manifest(cfg).items():
        if name == "modality_postprocessors.text.1.log_logit_scale":
            sd[name] = np.asarray(np.log(cfg.logit_scale_init), dtype=np.float32)
        else:
            sd[name] = rng.randn(*shape).astype(np.float32) * 0.05
    return sd


# ---------------------------------------------------------------------------
# Preprocessing (host) + extractor builder
# ---------------------------------------------------------------------------


def preprocess_images(images, cfg: ImageBindConfig) -> np.ndarray:
    """ImageBind's ``load_and_transform_vision_data`` -> [B, 3, S, S] float32
    (host, PIL).

    torchvision's ``Resize(S, BICUBIC)`` on the PIL image: the short side to
    S, the long side to ``int(S * long / short)``; ``CenterCrop(S)`` at the
    offset ``int(round((size - S) / 2.0))`` on each axis; ``ToTensor`` (/ 255)
    and CLIP's ``Normalize`` (mean and std in float64, rounded once).  A
    divergence by design from the JAX package, which rounds the long side
    and crops at ``(size - S) // 2``: at COCO's 640 x 480 it resizes to
    299 x 224 where the published transform takes 298 x 224.
    """
    from PIL import Image

    s = cfg.image_size
    out = np.empty((len(images), 3, s, s), np.float32)
    for i, img in enumerate(images):
        if not isinstance(img, Image.Image):
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            img = Image.fromarray(arr)
        img = img.convert("RGB")
        w, h = img.size
        long = int(s * max(w, h) / min(w, h))
        img = img.resize((s, long) if w <= h else (long, s), Image.BICUBIC)
        w, h = img.size
        left, top = int(round((w - s) / 2.0)), int(round((h - s) / 2.0))
        img = img.crop((left, top, left + s, top + s))
        x = np.asarray(img, np.float32) / 255.0
        out[i] = ((x - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)
    return out


def clip_tokenize(captions, cfg: ImageBindConfig, tokenizer=None) -> np.ndarray:
    """[B, context_length] int32: [SOT] + BPE + [EOT], zero-padded/truncated.

    The BPE vocabulary is data that cannot be synthesised: by default this
    uses the HF CLIP tokenizer (same merges as ImageBind's SimpleTokenizer)
    from the local cache; pass ``tokenizer`` (captions -> list[list[int]] of
    ids WITHOUT specials) to substitute any implementation.  Counter
    ``mdt.extract.text_tokens``: the ids before padding, SOT and EOT included.
    """
    if tokenizer is None:
        from transformers import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained("openai/clip-vit-large-patch14")

        def tokenizer(texts):
            return tok(list(texts), add_special_tokens=False)["input_ids"]

    ids = np.zeros((len(captions), cfg.context_length), np.int32)
    n_tokens = 0
    for i, toks in enumerate(tokenizer(list(captions))):
        row = [SOT_TOKEN] + list(toks)[: cfg.context_length - 2] + [EOT_TOKEN]
        ids[i, : len(row)] = row
        n_tokens += len(row)
    count("mdt.extract.text_tokens", n_tokens)
    return ids


def make_imagebind_extractor(params: ImageBind, cfg: ImageBindConfig, tokenizer=None):
    """extract_fn(ids, captions, images) -> {LANG_CLS, VISION_CLS} [B, D].

    Mirrors ImagebindFeatureExtractor.extract_features_from_batch
    (extract_imagebind_features.py:20-31): TEXT embeds keep the learned
    logit scaling, VISION embeds are unit-normalized.  Tokens and pixels are
    made on the host; the forward runs on the modules' device.  Spans
    ``mdt.extract.tokens``, ``.prep``, ``.forward`` (both towers; stream time
    from the span's events) and ``.to_host`` (the copies back, where the host
    waits for the towers).
    """
    from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY

    def extract(ids, captions, images):
        with span("mdt.extract.tokens"):
            input_ids = clip_tokenize(captions, cfg, tokenizer)
        with span("mdt.extract.prep"):
            pixel_values = preprocess_images(images, cfg)
        with span("mdt.extract.forward"), torch.inference_mode():
            text_emb, vision_emb = imagebind_embed(params, cfg, input_ids, pixel_values)
        with span("mdt.extract.to_host"):
            return {
                LANG_CLS_FEAT_KEY: text_emb.cpu().numpy(),
                VISION_CLS_FEAT_KEY: vision_emb.cpu().numpy(),
            }

    return extract


def build_imagebind(pretrained: bool = True, checkpoint_path: str | None = None,
                    cfg: ImageBindConfig | None = None, seed: int = 0,
                    tokenizer=None, device=None):
    """(params, cfg, extract_fn) for 'imagebind' / 'random-imagebind'.

    ``pretrained=True`` loads the official checkpoint from
    ``checkpoint_path`` (or $IMAGEBIND_CKPT); ``pretrained=False`` is the
    seeded random-init control and needs no files.  ``params`` is the
    ``ImageBind`` module on ``device`` (default ``cuda``).
    """
    cfg = cfg or ImageBindConfig()
    if pretrained:
        path = checkpoint_path or os.environ.get("IMAGEBIND_CKPT", "")
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(
                "pretrained ImageBind needs the official imagebind_huge.pth "
                "checkpoint: pass checkpoint_path= or set $IMAGEBIND_CKPT "
                "(download from the FAIR release on a networked host)"
            )
        sd = torch.load(path, map_location="cpu", weights_only=True)
        params = params_from_torch_state_dict(sd, cfg, device)
    else:
        params = init_params(threefry.prng_key(seed), cfg, device)
    return params, cfg, make_imagebind_extractor(params, cfg, tokenizer)
