"""Gabor filterbank features as one convolution on the GPU.

Rebuild of the reference's feature_extraction/extract_gabor_features.py: the
160-kernel filterbank (8 orientations x 4 sigmas x 5 frequencies, :30-41),
wrap-mode convolution with mean+variance pooling (:44-50) producing 320-dim
features; captions are rendered to images and filtered with the same bank
(:97-121).  The reference fans out over 20 joblib processes; here the whole
bank is one batched ``F.conv2d`` on the device (kernels zero-padded to one
common size: zero padding does not change convolution outputs).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_decoding_tpu_torch.device import as_float32


def gabor_kernel(frequency, theta=0.0, sigma_x=1.0, sigma_y=1.0, n_stds=3, offset=0.0):
    """Real part of a Gabor kernel, skimage.filters.gabor_kernel-compatible."""
    x0 = math.ceil(
        max(abs(n_stds * sigma_x * math.cos(theta)), abs(n_stds * sigma_y * math.sin(theta)), 1)
    )
    y0 = math.ceil(
        max(abs(n_stds * sigma_y * math.cos(theta)), abs(n_stds * sigma_x * math.sin(theta)), 1)
    )
    y, x = np.mgrid[-y0 : y0 + 1, -x0 : x0 + 1].astype(np.float64)
    rotx = x * math.cos(theta) + y * math.sin(theta)
    roty = -x * math.sin(theta) + y * math.cos(theta)
    g = np.exp(-0.5 * (rotx**2 / sigma_x**2 + roty**2 / sigma_y**2))
    g /= 2 * np.pi * sigma_x * sigma_y
    g = g * np.exp(1j * (2 * np.pi * frequency * rotx + offset))
    return np.real(g)


def make_gabor_filterbank():
    """160 kernels (extract_gabor_features.py:30-41)."""
    kernels = []
    for t in range(8):
        theta = t / 8.0 * np.pi
        for sigma in (1, 3, 5, 7):
            for frequency in (0, 2, 4, 8, 16):
                kernels.append(
                    gabor_kernel(frequency, theta=theta, sigma_x=sigma, sigma_y=sigma)
                )
    return kernels


def _padded_bank(kernels):
    """Zero-pad all kernels to a common odd size -> [n_k, S, S] array."""
    size = max(max(k.shape) for k in kernels)
    if size % 2 == 0:
        size += 1
    bank = np.zeros((len(kernels), size, size), dtype=np.float32)
    for i, k in enumerate(kernels):
        py = (size - k.shape[0]) // 2
        px = (size - k.shape[1]) // 2
        bank[i, py : py + k.shape[0], px : px + k.shape[1]] = k
    return bank


def compute_gabor_feats_batch(images, bank=None, device=None) -> torch.Tensor:
    """[B, H, W] grayscale images -> [B, n_k*2] (mean, var per kernel).

    Parity with compute_gabor_feats (:44-50): scipy ndimage.convolve semantics
    (true convolution = correlation with the flipped kernel) with
    mode='wrap' (circular padding), feature order [k0_mean, k0_var, k1_mean,
    k1_var, ...], population variance.  Arrays go to ``device`` (default
    ``cuda``); a tensor stays on its device; the bank and the result follow
    the images' device and dtype (float32 unless a float64 tensor is given).
    """
    x = images if isinstance(images, torch.Tensor) and images.dtype == torch.float64 \
        else as_float32(images, device)
    if bank is None:
        bank = _padded_bank(make_gabor_filterbank())
    w = torch.as_tensor(bank).to(x.device, x.dtype)
    half = w.shape[-1] // 2
    # circular pad then an unpadded conv == ndimage mode='wrap'; conv2d is a
    # cross-correlation, so the kernels are flipped
    x = F.pad(x[:, None], (half, half, half, half), mode="circular")
    out = F.conv2d(x, w.flip(-2, -1)[:, None])  # [B, n_k, H, W]
    mean = out.mean(dim=(2, 3))
    var = out.var(dim=(2, 3), correction=0)
    return torch.stack([mean, var], dim=-1).reshape(out.shape[0], -1)


def preprocess_image(pil_image, img_size: int = 256) -> np.ndarray:
    """Resize-to-width + center-crop + grayscale (extract_gabor_features.py:76-85)."""
    resized = pil_image.resize(
        (img_size, round((pil_image.height / pil_image.width) * img_size))
    )
    cropped = resized.crop(
        (0, round((resized.height - img_size) / 2), resized.width,
         round((resized.height + img_size) / 2))
    )
    return np.asarray(cropped.convert("L"), dtype=np.float32)


def render_caption(caption: str, img_size: int = 256, max_len: int = 70) -> np.ndarray:
    """Caption -> grayscale text image (extract_gabor_features.py:97-118).

    Uses PIL's default font (the reference's specific ttf is not bundled).
    """
    from PIL import Image, ImageDraw, ImageFont

    caption = caption[:max_len]
    font = ImageFont.load_default()
    img = Image.new("RGB", (img_size, img_size), "grey")
    d = ImageDraw.Draw(img)
    bbox = d.textbbox((0, 0), caption, font=font)
    text_width = bbox[2] - bbox[0]
    d.text(((img_size - text_width) / 2, img_size / 2), caption, fill="white", font=font)
    return np.asarray(img.convert("L"), dtype=np.float32)


def make_gabor_extractor(img_size: int = 256, device=None):
    """Harness-compatible extract_fn for run_extraction (model name 'gabor'):
    images are decoded on the host, filtered on ``device`` (default ``cuda``)."""
    from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY

    bank = _padded_bank(make_gabor_filterbank())

    def extract(ids, captions, images):
        img_arr = np.stack([preprocess_image(im, img_size) for im in images])
        cap_arr = np.stack([render_caption(c, img_size) for c in captions])
        return {
            VISION_CLS_FEAT_KEY: compute_gabor_feats_batch(img_arr, bank, device).cpu().numpy(),
            LANG_CLS_FEAT_KEY: compute_gabor_feats_batch(cap_arr, bank, device).cpu().numpy(),
        }

    return extract
