"""ImageBind-Huge's text and vision embeddings, worked out plainly from the
official checkpoint's key names and ImageBind's published forward.

What the extraction CLI has to produce for a stimulus (caption, JPEG):

* the image transform of ``data.load_and_transform_vision_data``:
  torchvision's ``Resize(224, BICUBIC)`` on the PIL image (the short side to
  224, the long side ``int(224 * long / short)``), ``CenterCrop(224)`` (the
  offset ``int(round((size - 224) / 2))``), ``ToTensor`` (/ 255) and CLIP's
  ``Normalize``.  The resize is PIL's 8-bit bicubic (``resize_bicubic``,
  Pillow's two-pass fixed-point resampling, bit for bit); the JPEG is
  decoded by the caller;
* the vision tower: ``PadIm2Video`` (the still repeated to 2 frames), the
  ``Conv3d`` stem (kernel = stride = (2, 14, 14), no bias), the class token,
  the position embedding, the pre-transformer LayerNorm, 32 pre-norm blocks
  (``nn.MultiheadAttention``, exact GELU MLP, LayerNorm eps 1e-6), the head
  (LayerNorm, token 0, a linear map without bias) and unit norm;
* the text tower: ``[SOT] + BPE ids + [EOT]``, zero-padded to 77, the token
  and position embeddings, 24 pre-norm blocks under a causal mask (-inf
  above the diagonal, over the whole padded context), the state at the EOT
  token (``argmax`` of the ids), the head (LayerNorm, a linear map without
  bias), unit norm, times ``min(exp(log_logit_scale), 100)``.

``embed`` computes both in ``dtype`` on ``device`` from the checkpoint file,
a block of stimuli at a time.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOT, EOT = 49406, 49407  # CLIP BPE's start and end of text; EOT is the largest id
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-6
MAX_LOGIT_SCALE = 100.0
PRECISION_BITS = 22  # Pillow's fixed point for 8-bit resampling: 32 - 8 - 2


# ---------------------------------------------------------------------------
# The official checkpoint's keys
# ---------------------------------------------------------------------------


def checkpoint_shapes(cfg: dict) -> dict:
    """{key: shape} of every tensor of ``imagebind_huge.pth`` that the text
    and vision embeddings use, and the text causal mask buffer."""
    dv, dt, out = cfg["vision_embed_dim"], cfg["text_embed_dim"], cfg["out_embed_dim"]
    p, t = cfg["patch_size"], cfg["n_frames"]
    n_tokens = (cfg["image_size"] // p) ** 2 + 1
    L = cfg["context_length"]
    shapes = {
        "modality_preprocessors.vision.cls_token": (1, 1, dv),
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight": (dv, 3, t, p, p),
        "modality_preprocessors.vision.pos_embedding_helper.pos_embed": (1, n_tokens, dv),
        "modality_preprocessors.text.token_embedding.weight": (cfg["vocab_size"], dt),
        "modality_preprocessors.text.pos_embed": (1, L, dt),
        "modality_preprocessors.text.mask": (L, L),
        "modality_trunks.vision.pre_transformer_layer.0.weight": (dv,),
        "modality_trunks.vision.pre_transformer_layer.0.bias": (dv,),
    }
    for tower, d, n in (("vision", dv, cfg["vision_layers"]), ("text", dt, cfg["text_layers"])):
        h = int(d * cfg["mlp_ratio"])
        for i in range(n):
            b = f"modality_trunks.{tower}.blocks.{i}."
            shapes.update({
                b + "attn.in_proj_weight": (3 * d, d), b + "attn.in_proj_bias": (3 * d,),
                b + "attn.out_proj.weight": (d, d), b + "attn.out_proj.bias": (d,),
                b + "norm_1.weight": (d,), b + "norm_1.bias": (d,),
                b + "norm_2.weight": (d,), b + "norm_2.bias": (d,),
                b + "mlp.fc1.weight": (h, d), b + "mlp.fc1.bias": (h,),
                b + "mlp.fc2.weight": (d, h), b + "mlp.fc2.bias": (d,),
            })
    shapes.update({
        "modality_heads.vision.0.weight": (dv,), "modality_heads.vision.0.bias": (dv,),
        "modality_heads.vision.2.weight": (out, dv),
        "modality_heads.text.proj.0.weight": (dt,), "modality_heads.text.proj.0.bias": (dt,),
        "modality_heads.text.proj.1.weight": (out, dt),
        "modality_postprocessors.text.1.log_logit_scale": (),
    })
    return shapes


def causal_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """ImageBind's ``build_causal_attention_mask``: -inf above the diagonal."""
    return torch.full((n, n), float("-inf"), dtype=dtype, device=device).triu_(1)


# ---------------------------------------------------------------------------
# The image transform
# ---------------------------------------------------------------------------


def _bicubic(x: float) -> float:
    """Pillow's bicubic kernel, a = -0.5."""
    a, x = -0.5, abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(n_in: int, n_out: int) -> tuple:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``:
    (source index [n_out, k], fixed-point weight [n_out, k]); unused taps
    point at 0 with weight 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    k = int(np.ceil(support)) * 2 + 1
    index = np.zeros((n_out, k), np.int64)
    weight = np.zeros((n_out, k), np.int64)
    for j in range(n_out):
        center = (j + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), n_in) - lo
        w = [_bicubic((i + lo - center + 0.5) / filterscale) for i in range(n)]
        total = sum(w)
        for i, v in enumerate(w):
            v = v / total if total != 0.0 else v
            index[j, i] = lo + i
            weight[j, i] = int((-0.5 if v < 0 else 0.5) + v * (1 << PRECISION_BITS))
    return index, weight


def _pass(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    index, weight = _coefficients(img.shape[axis], n_out)
    taps = np.take(img, index, axis=axis).astype(np.int64)  # the axis becomes [n_out, k]
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = weight.shape
    acc = (taps * weight.reshape(shape)).sum(axis=axis + 1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``PIL.Image.resize((width, height), BICUBIC)`` of an 8-bit [H, W, C]
    image: a horizontal pass, rounded to 8 bits, then a vertical one; a
    pass whose size does not change is skipped."""
    if img.shape[1] != width:
        img = _pass(img, 1, width)
    if img.shape[0] != height:
        img = _pass(img, 0, height)
    return img


def transform(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision's Resize(size, BICUBIC), CenterCrop(size), ToTensor and
    CLIP's Normalize of a decoded 8-bit RGB image [H, W, 3]: [3, size, size]
    float64."""
    h, w = img.shape[:2]
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(size * long / short)
    new_w, new_h = (size, new_long) if w <= h else (new_long, size)
    img = resize_bicubic(img, new_w, new_h)
    top, left = int(round((new_h - size) / 2.0)), int(round((new_w - size) / 2.0))
    x = img[top:top + size, left:left + size].astype(np.float64) / 255.0
    return ((x - np.array(IMAGE_MEAN)) / np.array(IMAGE_STD)).transpose(2, 0, 1)


def tokens(id_lists: list, context: int) -> np.ndarray:
    """[B, context] int64: SOT, the caption's BPE ids, EOT, zeros."""
    out = np.zeros((len(id_lists), context), np.int64)
    for i, ids in enumerate(id_lists):
        row = [SOT, *ids, EOT]
        if len(row) > context:
            raise ValueError(f"a caption of {len(ids)} tokens does not fit {context}")
        out[i, :len(row)] = row
    return out


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------


def load(path: str, dtype, device) -> dict:
    """The checkpoint's tensors in ``dtype`` on ``device``."""
    sd = torch.load(path, map_location=device, weights_only=True)
    return {k: v.to(dtype) for k, v in sd.items()}


def _block(w: dict, prefix: str, x: torch.Tensor, heads: int, mask) -> torch.Tensor:
    """``BlockWithMasking`` on [L, B, D]: x + attn(norm_1(x)), then + mlp(norm_2(x))."""
    d = x.shape[-1]
    y = F.layer_norm(x, (d,), w[prefix + "norm_1.weight"], w[prefix + "norm_1.bias"], LN_EPS)
    y = F.multi_head_attention_forward(
        y, y, y, d, heads, w[prefix + "attn.in_proj_weight"], w[prefix + "attn.in_proj_bias"],
        None, None, False, 0.0, w[prefix + "attn.out_proj.weight"],
        w[prefix + "attn.out_proj.bias"], training=False, need_weights=False, attn_mask=mask)[0]
    x = x + y
    y = F.layer_norm(x, (d,), w[prefix + "norm_2.weight"], w[prefix + "norm_2.bias"], LN_EPS)
    y = F.linear(F.gelu(F.linear(y, w[prefix + "mlp.fc1.weight"], w[prefix + "mlp.fc1.bias"])),
                 w[prefix + "mlp.fc2.weight"], w[prefix + "mlp.fc2.bias"])
    return x + y


def vision(w: dict, pixels: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, 3, S, S] normalised images -> unit [B, out] embeddings."""
    video = pixels.unsqueeze(2).expand(-1, -1, cfg["n_frames"], -1, -1)  # PadIm2Video, repeat
    stem = w["modality_preprocessors.vision.rgbt_stem.proj.1.weight"]
    x = F.conv3d(video, stem, stride=tuple(stem.shape[2:])).flatten(2).transpose(1, 2)
    cls = w["modality_preprocessors.vision.cls_token"].expand(len(x), -1, -1)
    x = torch.cat([cls, x], dim=1) + w["modality_preprocessors.vision.pos_embedding_helper.pos_embed"]
    d = x.shape[-1]
    x = F.layer_norm(x, (d,), w["modality_trunks.vision.pre_transformer_layer.0.weight"],
                     w["modality_trunks.vision.pre_transformer_layer.0.bias"], LN_EPS)
    x = x.transpose(0, 1)
    for i in range(cfg["vision_layers"]):
        x = _block(w, f"modality_trunks.vision.blocks.{i}.", x, cfg["vision_heads"], None)
    x = F.layer_norm(x[0], (d,), w["modality_heads.vision.0.weight"],
                     w["modality_heads.vision.0.bias"], LN_EPS)
    return F.normalize(F.linear(x, w["modality_heads.vision.2.weight"]), dim=-1)


def text(w: dict, ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, L] token ids -> [B, out] embeddings, unit norm times the logit scale."""
    x = F.embedding(ids, w["modality_preprocessors.text.token_embedding.weight"])
    x = (x + w["modality_preprocessors.text.pos_embed"]).transpose(0, 1)
    mask = causal_mask(ids.shape[1], x.dtype, x.device)
    for i in range(cfg["text_layers"]):
        x = _block(w, f"modality_trunks.text.blocks.{i}.", x, cfg["text_heads"], mask)
    x = x.transpose(0, 1)[torch.arange(len(ids), device=ids.device), ids.argmax(dim=-1)]
    d = x.shape[-1]
    x = F.layer_norm(x, (d,), w["modality_heads.text.proj.0.weight"],
                     w["modality_heads.text.proj.0.bias"], LN_EPS)
    x = F.normalize(F.linear(x, w["modality_heads.text.proj.1.weight"]), dim=-1)
    scale = w["modality_postprocessors.text.1.log_logit_scale"].exp().clamp(max=MAX_LOGIT_SCALE)
    return scale * x


@torch.no_grad()
def embed(path: str, images: list, id_lists: list, cfg: dict, dtype=torch.float64,
          device="cpu", chunk: int = 24) -> dict:
    """{"text": [S, out], "vision": [S, out]} float64 numpy embeddings of the
    stimuli (decoded 8-bit RGB images, BPE id lists), the towers computed in
    ``dtype`` from the checkpoint at ``path``, ``chunk`` stimuli at a time."""
    w = load(path, dtype, device)
    out = {"text": [], "vision": []}
    for s in range(0, len(images), chunk):
        px = np.stack([transform(img, cfg["image_size"]) for img in images[s:s + chunk]])
        ids = tokens(id_lists[s:s + chunk], cfg["context_length"])
        out["vision"].append(vision(w, torch.as_tensor(px, dtype=dtype, device=device), cfg))
        out["text"].append(text(w, torch.as_tensor(ids, device=device), cfg))
    return {k: torch.cat(v).double().cpu().numpy() for k, v in out.items()}
