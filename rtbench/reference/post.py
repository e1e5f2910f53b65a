"""Plain bloom, exposure, tonemap and sRGB bytes (the upstream renderer's
post-pass, raytracing.cu / main): bloom keeps pixels whose Rec.709
luminance exceeds 0.7 × rays per pixel, box-blurs them (radius 5,
separable, horizontal first, each tap dividing by the taps in bounds) and
adds them back; then ``x = max(exposure / spp · sum, 0)``,
``sqrt(x / (x + 1))``, × 255.999 truncated to a byte."""

from __future__ import annotations

import numpy as np
import torch

LUMA = (0.2126, 0.7152, 0.0722)
RADIUS = 5


def _blur_axis(image: torch.Tensor, axis: int) -> torch.Tensor:
    size = image.shape[axis]
    total = torch.zeros_like(image)
    count = torch.zeros(image.shape[:2], dtype=image.dtype, device=image.device)
    idx = torch.arange(size, device=image.device)
    shape = [1, 1]
    shape[axis] = size
    for off in range(-RADIUS, RADIUS + 1):
        shifted = torch.roll(image, shifts=-off, dims=axis)
        valid = ((idx >= max(0, -off)) & (idx < size - max(0, off))).reshape(shape)
        total = total + torch.where(valid[..., None], shifted, 0.0)
        count = count + valid.to(image.dtype)
    return total / count[..., None]


def image_bytes(framebuffer: torch.Tensor, width: int, height: int, rays_per_pixel: int,
                exposure: float, dtype=torch.float32) -> np.ndarray:
    """(pixels, 3) raw sums → (H, W, 3) uint8, computed in ``dtype``."""
    image = framebuffer.reshape(height, width, 3).to(dtype)
    luma = torch.tensor(LUMA, dtype=dtype, device=image.device)
    threshold = float(np.float32(0.7 * rays_per_pixel))
    bright = torch.where(((image * luma).sum(dim=-1) > threshold)[..., None], image, 0.0)
    image = image + _blur_axis(_blur_axis(bright, 1), 0)
    scale = float(np.float32(exposure) / np.float32(rays_per_pixel))
    x = torch.clamp_min(scale * image, 0.0)
    display = torch.sqrt(x / (x + 1.0))
    return (display * float(np.float32(255.999))).to(torch.uint8).cpu().numpy()
