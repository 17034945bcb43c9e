"""Spatial motion-energy pyramid features (pymoten-equivalent) on the GPU.

The reference vendors a pymoten fork as a submodule (.gitmodules:1-6) and
sketches its use for static stimuli
(the reference's feature_extraction/extract_gabor_features.py:88-116,
commented: ``pyramid.project_stimulus(luminance, spatial_only=True)`` with
``temporal_frequencies=[0]``).  This module provides the same capability as a
batched computation: a pyramid of spatially-localised quadrature Gabor
filters (multiple spatial frequencies x orientations x grid positions), each
yielding one energy channel ``sqrt(sin^2 + cos^2)``.

Capability-equivalent, not filter-for-filter identical to pymoten's default
pyramid (whose exact layout tables are part of that package); the channel
structure (sf x orientation x position, quadrature energy) matches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import as_float32, resolve_device


@dataclass
class SpatialPyramidSpec:
    """Filter layout: per spatial frequency, an orientation bank on a grid."""

    spatial_frequencies: tuple = (0, 2, 4, 8, 16)  # cycles per image
    orientations: tuple = (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4)
    # grid spacing in filter-envelope units; envelope sigma = sf_to_sigma/image
    positions_per_cycle: float = 1.0
    sf_to_sigma: float = 0.6  # envelope sigma relative to the wavelength


def _filter_grid(sf: float, image_size: int, spec: SpatialPyramidSpec):
    """Centers for one spatial-frequency level (denser for higher sf)."""
    if sf == 0:
        return [(image_size / 2, image_size / 2)], image_size * 0.35
    wavelength = image_size / sf
    sigma = spec.sf_to_sigma * wavelength
    spacing = max(1.0, wavelength * spec.positions_per_cycle)
    n = max(1, int(round(image_size / spacing)))
    offs = (np.arange(n) + 0.5) * (image_size / n)
    centers = [(y, x) for y in offs for x in offs]
    return centers, sigma


def build_spatial_pyramid(image_size: int, spec: SpatialPyramidSpec | None = None):
    """-> (sin_bank [n_f, H, W], cos_bank [n_f, H, W], channel descriptions)."""
    spec = spec or SpatialPyramidSpec()
    ys, xs = np.mgrid[0:image_size, 0:image_size].astype(np.float64)
    sin_bank, cos_bank, channels = [], [], []
    for sf in spec.spatial_frequencies:
        centers, sigma = _filter_grid(sf, image_size, spec)
        freq = sf / image_size  # cycles per pixel
        orientations = spec.orientations if sf > 0 else (0.0,)
        for cy, cx in centers:
            envelope = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma**2))
            for theta in orientations:
                phase = 2 * np.pi * freq * (
                    (xs - cx) * math.cos(theta) + (ys - cy) * math.sin(theta)
                )
                sin_bank.append(envelope * np.sin(phase))
                cos_bank.append(envelope * np.cos(phase))
                channels.append({"sf": sf, "theta": theta, "cy": cy, "cx": cx})
    return (
        np.stack(sin_bank).astype(np.float32),
        np.stack(cos_bank).astype(np.float32),
        channels,
    )


def motion_energy_features(images, sin_bank=None, cos_bank=None,
                           image_size: int | None = None,
                           spec: SpatialPyramidSpec | None = None,
                           device=None) -> torch.Tensor:
    """[B, H, W] grayscale/luminance images -> [B, n_channels] energies.

    Each channel is the quadrature energy of one localised Gabor:
    sqrt((img . sin_filter)^2 + (img . cos_filter)^2), one matmul per
    quadrature bank.  Arrays go to ``device`` (default ``cuda``); a tensor
    stays on its device; the banks (arrays or tensors) follow the images'
    device and dtype (float32 unless a float64 tensor is given): banks
    already on that device are not copied.
    """
    x = images if isinstance(images, torch.Tensor) and images.dtype == torch.float64 \
        else as_float32(images, device)
    if sin_bank is None:
        sin_bank, cos_bank, _ = build_spatial_pyramid(image_size or x.shape[-1], spec)
    flat = x.reshape(x.shape[0], -1)
    sb, cb = (torch.as_tensor(b).to(x.device, x.dtype).reshape(len(b), -1)
              for b in (sin_bank, cos_bank))
    s = flat @ sb.T
    c = flat @ cb.T
    return torch.sqrt(s * s + c * c)


def rgb_to_luminance(rgb: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] uint8/float -> [..., H, W] luminance (pymoten's
    imagearray2luminance role: Rec.601 luma)."""
    rgb = np.asarray(rgb, dtype=np.float64)
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(
        np.float32
    )


def make_motion_energy_extractor(img_size: int = 96, spec: SpatialPyramidSpec | None = None,
                                 device=None):
    """Harness-compatible extract_fn (model name 'moten'): images are decoded
    on the host, projected on ``device`` (default ``cuda``), where the banks
    are uploaded once."""
    from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY
    from multimodal_decoding_tpu_torch.extraction.gabor import preprocess_image, render_caption

    device = resolve_device(device)
    sin_bank, cos_bank = (torch.as_tensor(b, device=device)
                          for b in build_spatial_pyramid(img_size, spec)[:2])

    def extract(ids, captions, images):
        img_arr = np.stack([preprocess_image(im, img_size) for im in images])
        cap_arr = np.stack([render_caption(c, img_size) for c in captions])
        return {
            VISION_CLS_FEAT_KEY:
                motion_energy_features(img_arr, sin_bank, cos_bank, device=device).cpu().numpy(),
            LANG_CLS_FEAT_KEY:
                motion_energy_features(cap_arr, sin_bank, cos_bank, device=device).cpu().numpy(),
        }

    return extract
