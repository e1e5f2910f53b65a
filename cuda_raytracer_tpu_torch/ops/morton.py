"""Morton (Z-order) sort keys for wavefront ray reordering (counterpart of
``cuda_raytracer_tpu/ops/morton.py``).

5 bits per axis for origin and direction, interleaved into 15-bit codes and
packed as ``origin_code << 16 | direction_code`` in a 32-bit key; dead rays
get ``DEAD_RAY_KEY`` so an ascending sort puts them last (scene.cu:42-60,
480-485). The interleave is the correct 3-way bit spread (masks 0x100F /
0x10C3 / 0x1249), not the reference's hex-for-binary mask (SURVEY quirk
Q1), and origins are normalised by the scene extent (quirk Q5).

Keys are uint32 values held in int64 tensors (torch has no uint32
arithmetic on the CPU), so sorting them as int64 orders them as uint32.
"""

from __future__ import annotations

import torch

from cuda_raytracer_tpu_torch.ops import vecmath

DEAD_RAY_KEY = 0xFFFFFFFF


def interleave_5(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 5 bits of ``x`` to every 3rd bit: 0bABCDE →
    0bA00B00C00D00E (int64 in, int64 out)."""
    x = x & 0x1F
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def morton_code(v: torch.Tensor) -> torch.Tensor:
    """15-bit Morton code of points ``v`` in [0, 1]^3, (..., 3) float32 →
    (...,) int64, quantised as ``(ushort)(x * 31.99)`` (scene.cu:53-60)."""
    q = (v * 31.99).to(torch.int64)
    return (
        interleave_5(q[..., 0])
        | (interleave_5(q[..., 1]) << 1)
        | (interleave_5(q[..., 2]) << 2)
    )


def ray_sort_keys(
    origin: torch.Tensor,
    direction: torch.Tensor,
    alive: torch.Tensor,
    min_coord: torch.Tensor,
    inv_extent: torch.Tensor,
) -> torch.Tensor:
    """32-bit coherence keys (int64 holding uint32): high half the Morton
    code of the normalised origin, low half that of the direction mapped
    from [-1, 1] to [0, 1]; dead rays → ``DEAD_RAY_KEY``."""
    origin_unit = vecmath.clamp01((origin - min_coord) * inv_extent)
    dir_unit = 0.5 * (direction + 1.0)
    keys = (morton_code(origin_unit) << 16) | morton_code(dir_unit)
    return torch.where(alive, keys, DEAD_RAY_KEY)
