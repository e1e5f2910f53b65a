"""Bloom post-process (counterpart of ``cuda_raytracer_tpu/ops/bloom.py``).

Runs on the raw accumulated framebuffer before exposure/tonemap: a
high-pass keeps pixels whose Rec.709 luminance exceeds
``0.7 * rays_per_pixel``, a separable radius-5 box blur (divisor = number of
in-bounds taps) smears them, and the result is added back.
"""

from __future__ import annotations

import numpy as np
import torch

REC709_LUMA = (0.2126, 0.7152, 0.0722)
DEFAULT_RADIUS = 5
THRESHOLD_SCALE = 0.7


def high_pass(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Keep pixels with perceived luminance above ``threshold``."""
    luma = torch.tensor(REC709_LUMA, dtype=image.dtype, device=image.device)
    luminance = (image * luma).sum(dim=-1)
    return torch.where((luminance > threshold)[..., None], image, 0.0)


def _box_blur_axis(image: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """1D box blur along ``axis``; out-of-bounds taps add nothing to the sum
    or to the divisor."""
    size = image.shape[axis]
    total = torch.zeros_like(image)
    count = torch.zeros(image.shape[:2], dtype=image.dtype, device=image.device)
    idx = torch.arange(size, device=image.device)
    shape = [1, 1]
    shape[axis] = size
    for offset in range(-radius, radius + 1):
        # shifted[x] = image[x + offset], valid while x + offset is in bounds.
        shifted = torch.roll(image, shifts=-offset, dims=axis)
        valid = ((idx >= max(0, -offset)) & (idx < size - max(0, offset))).reshape(shape)
        total = total + torch.where(valid[..., None], shifted, 0.0)
        count = count + valid.to(image.dtype)
    return total / count[..., None]


def box_blur(image: torch.Tensor, radius: int = DEFAULT_RADIUS) -> torch.Tensor:
    """Separable box blur, horizontal then vertical."""
    return _box_blur_axis(_box_blur_axis(image, radius, axis=1), radius, axis=0)


def apply_bloom(
    accumulated: torch.Tensor, rays_per_pixel: int, radius: int = DEFAULT_RADIUS
) -> torch.Tensor:
    """Full bloom chain on an (H, W, 3) raw accumulated framebuffer."""
    threshold = float(np.float32(THRESHOLD_SCALE * rays_per_pixel))
    return accumulated + box_blur(high_pass(accumulated, threshold), radius)
