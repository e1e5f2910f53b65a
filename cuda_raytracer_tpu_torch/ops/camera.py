"""Primary-ray generation (counterpart of ``cuda_raytracer_tpu/ops/camera.py``).

Ray ``i`` belongs to pixel ``i // rays_per_pixel`` (pixel-major), jittered
across the pixel footprint with two draws from its PCG stream, seeded like
the reference: ``ray_index * 298592570346 + 709579 * seed`` truncated to 32
bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuda_raytracer_tpu_torch.ops import rng, vecmath
from cuda_raytracer_tpu_torch.ops.kernels import rays

# 298592570346 mod 2^32 (the 64-bit literal is multiplied into a 32-bit seed).
RAY_SEED_MULT = 2239826922
PASS_SEED_MULT = 709579


def _seed_add(pass_seed) -> int:
    return (PASS_SEED_MULT * (int(pass_seed) & rng.MASK32)) & rng.MASK32


def initial_ray_seeds(ray_index: torch.Tensor, pass_seed) -> torch.Tensor:
    """Per-ray 32-bit seeds (int64 holding uint32 values)."""
    return (rng.mul32(rng.as_u32(ray_index), RAY_SEED_MULT) + _seed_add(pass_seed)) & rng.MASK32


def generate_rays(
    camera,
    width: int,
    rays_per_pixel: int,
    ray_index: torch.Tensor,  # (R,) int32 — global ray indices
    pass_seed,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera rays for the given global ray indices → (origin (R,3),
    direction (R,3)); direction = normalise(top_left + x·right_scaled −
    y·up_scaled). With ``plain`` the jitter's draws come from the torch PCG
    on any device."""
    pixel = torch.div(ray_index, rays_per_pixel, rounding_mode="floor")
    px = torch.remainder(pixel, width).to(torch.float32)
    py = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)

    # The two draws of initial_ray_seeds' streams: one kernel on the card.
    if plain:
        draws = rng.uniforms(initial_ray_seeds(ray_index, pass_seed), 2)
    else:
        draws = rays.pcg_draws(ray_index.to(torch.int32).contiguous(), RAY_SEED_MULT,
                               _seed_add(pass_seed), 2)
    jitter_x = rng.to_01(draws[0])
    jitter_y = rng.to_01(draws[1])

    x = (px + jitter_x) * camera.inv_width
    y = (py + jitter_y) * camera.inv_height

    direction = vecmath.normalise(
        camera.near_plane_top_left[None, :]
        + x[:, None] * camera.scaled_right[None, :]
        - y[:, None] * camera.scaled_up[None, :]
    )
    origin = camera.position[None, :].expand(direction.shape)
    return origin, direction
