"""Exposure, tonemap and sRGB conversion (counterpart of ``cuda_raytracer_tpu/ops/tonemap.py``).

``pixel = (exposure / rays_per_pixel) * accumulated``, HDR→SDR via
``x / (x + 1)``, approximate sRGB via sqrt, scaled by 255.999 to bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def tonemap(accumulated: torch.Tensor, exposure: float, rays_per_pixel: int) -> torch.Tensor:
    """Raw accumulated radiance sums (..., 3) → display-linear [0, 1]."""
    scale = float(np.float32(exposure) / np.float32(rays_per_pixel))
    pixel = torch.clamp_min(scale * accumulated, 0.0)
    return torch.sqrt(pixel / (pixel + 1.0))


def to_bytes(display: torch.Tensor) -> torch.Tensor:
    return (display * float(np.float32(255.999))).to(torch.uint8)
