"""Vector math on ``(..., 3)`` float32 tensors.

Counterpart of ``cuda_raytracer_tpu/ops/vecmath.py``. Sums over the three
components are written out left to right, ``(x + y) + z``, the order the
JAX reduction and the CUDA kernel both use, so the port rounds the same way.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def magnitude_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def magnitude(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(magnitude_squared(a))


def normalise(a: torch.Tensor) -> torch.Tensor:
    """Unit vector ``v / sqrt(sum)``, unguarded: a zero vector yields
    inf/nan, as in the reference."""
    return a / magnitude(a)[..., None]


def normalise_safe(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalise with |v| clamped away from 0."""
    return a / torch.clamp_min(magnitude(a), eps)[..., None]


def clamp01(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a, 0.0, 1.0)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a + (b - a) * t


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror ``direction`` about ``normal``."""
    return direction - 2.0 * dot(normal, direction)[..., None] * normal
