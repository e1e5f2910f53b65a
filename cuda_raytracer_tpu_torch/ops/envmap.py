"""Environment-map sampling on miss (counterpart of ``cuda_raytracer_tpu/ops/envmap.py``).

Per missed ray: the reference's hardcoded orientation transform (y/z swap
plus a rotation), equal-area octahedral sphere→square projection, then a
nearest (or, for reparameterised rendering, bilinear) texel fetch. The map
is indexed ``y * width + x`` (correct for non-square maps too). A 1×1 map
is a constant sky and is broadcast without a fetch; that is the branch the
brute-scene path takes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cuda_raytracer_tpu_torch.ops import vecmath

_ROT_A = float(np.float32(-0.386527))
_ROT_B = float(np.float32(0.922278))
_TWO_OVER_PI = float(np.float32(2.0 / math.pi))


def rotate_to_map_space(direction: torch.Tensor) -> torch.Tensor:
    """y/z swap plus a rotation about the new z axis."""
    dx = direction[..., 0] * _ROT_A + direction[..., 2] * _ROT_B
    dy = direction[..., 0] * -_ROT_B + direction[..., 2] * _ROT_A
    dz = direction[..., 1]
    return torch.stack([dx, dy, dz], dim=-1)


def equal_area_sphere_to_square(direction: torch.Tensor) -> torch.Tensor:
    """Equal-area octahedral projection of unit directions to [0,1]^2,
    branchless. Returns (..., 2) u,v."""
    x = torch.abs(direction[..., 0])
    y = torch.abs(direction[..., 1])
    z = torch.abs(direction[..., 2])

    r = torch.sqrt(torch.clamp_min(1.0 - torch.clamp_max(z, 1.0), 0.0))
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    b = torch.where(a == 0, 0.0, b / torch.where(a == 0, 1.0, a))

    phi = _TWO_OVER_PI * torch.atan(b)
    phi = torch.where(x < y, 1.0 - phi, phi)

    v = phi * r
    u = r - v

    # Southern hemisphere: reflect across the diagonal.
    south = direction[..., 2] < 0
    u_s = 1.0 - v
    v_s = 1.0 - u
    u = torch.where(south, u_s, u)
    v = torch.where(south, v_s, v)

    u = torch.copysign(u, direction[..., 0])
    v = torch.copysign(v, direction[..., 1])
    return torch.stack([(u + 1.0) * 0.5, (v + 1.0) * 0.5], dim=-1)


def sample_environment(
    env_map: torch.Tensor, direction: torch.Tensor, bilinear: bool = False
) -> torch.Tensor:
    """Radiance from the environment for (..., 3) unit directions.

    ``bilinear=False``: nearest fetch with the reference's rounding
    ``(int)(clamp01(c) * (dim - 1) + 0.5)``. ``bilinear=True``: 4-tap
    bilinear filtering, smooth in direction."""
    height, width = env_map.shape[0], env_map.shape[1]
    if height * width == 1:
        return env_map.reshape(3).expand(direction.shape[:-1] + (3,))
    uv = equal_area_sphere_to_square(rotate_to_map_space(direction))
    flat = env_map.reshape(-1, 3)
    if not bilinear:
        texel_x = (vecmath.clamp01(uv[..., 0]) * (width - 1) + 0.5).to(torch.int64)
        texel_y = (vecmath.clamp01(uv[..., 1]) * (height - 1) + 0.5).to(torch.int64)
        texel_x = torch.clamp(texel_x, 0, width - 1)
        texel_y = torch.clamp(texel_y, 0, height - 1)
        return flat[texel_y * width + texel_x]

    fx = vecmath.clamp01(uv[..., 0]) * (width - 1)
    fy = vecmath.clamp01(uv[..., 1]) * (height - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, width - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, height - 1)
    x1 = torch.clamp_max(x0 + 1, width - 1)
    y1 = torch.clamp_max(y0 + 1, height - 1)
    wx = (fx - x0.to(torch.float32))[..., None]
    wy = (fy - y0.to(torch.float32))[..., None]
    c00 = flat[y0 * width + x0]
    c01 = flat[y0 * width + x1]
    c10 = flat[y1 * width + x0]
    c11 = flat[y1 * width + x1]
    top = c00 * (1 - wx) + c01 * wx
    bottom = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bottom * wy
