"""Procedural substitute environment map.

The mounted reference checkout is missing ``teapot/textures/envmap.pfm``
(.MISSING_LARGE_BLOBS), so the teapot / glass_teapot / lamp scenes cannot load
their real sky. Any square PFM works for those scenes (SURVEY.md §2.9); this
module deterministically synthesises a plausible outdoor HDR sky — horizon
gradient plus a bright sun disc — in the equal-area octahedral layout the
sampler expects, so renders remain reproducible run-to-run.
"""

from __future__ import annotations

import numpy as np


def equal_area_square_to_sphere(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Inverse of the PBRT equal-area sphere→square mapping, on [0,1]^2 grids.
    Returns unit directions (..., 3). Used both here (to paint the sky by
    direction) and by the projection round-trip tests."""
    up = 2.0 * u - 1.0
    vp = 2.0 * v - 1.0
    absu, absv = np.abs(up), np.abs(vp)
    signed_distance = 1.0 - (absu + absv)
    abs_sd = np.abs(signed_distance)
    r = 1.0 - abs_sd
    phi = np.where(r == 0, 1.0, (absv - absu) / np.where(r == 0, 1.0, r) + 1.0) * (
        np.pi / 4.0
    )
    z = np.copysign(1.0 - r * r, signed_distance)
    cos_phi = np.copysign(np.cos(phi), up)
    sin_phi = np.copysign(np.sin(phi), vp)
    scale = r * np.sqrt(np.maximum(2.0 - r * r, 0.0))
    return np.stack([cos_phi * scale, sin_phi * scale, z], axis=-1)


def substitute_envmap(size: int = 256) -> np.ndarray:
    """Deterministic (size, size, 3) float32 HDR sky in equal-area layout."""
    ys, xs = np.meshgrid(
        (np.arange(size) + 0.5) / size, (np.arange(size) + 0.5) / size, indexing="ij"
    )
    # The sampler maps direction→(u,v) and indexes [y=v, x=u]; paint by the
    # direction each texel represents.
    dirs = equal_area_square_to_sphere(xs, ys)
    # The env lookup applies a fixed rotation with world-up landing on the
    # map's +z axis (scene.cu:378-382: dir_z = direction.y), so elevation in
    # map space is just z.
    elevation = dirs[..., 2]
    horizon = np.clip(1.0 - np.abs(elevation), 0.0, 1.0) ** 3
    sky_zenith = np.array([0.35, 0.52, 0.95])
    sky_horizon = np.array([0.85, 0.85, 0.92])
    ground = np.array([0.28, 0.25, 0.22])
    upper = sky_zenith[None, None] * (1 - horizon[..., None]) + sky_horizon[
        None, None
    ] * horizon[..., None]
    sky = np.where(elevation[..., None] >= 0, upper, ground[None, None] * (0.4 + 0.6 * horizon[..., None]))
    # Sun disc at a fixed direction.
    sun_dir = np.array([0.45, 0.35, 0.82])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cos_to_sun = dirs @ sun_dir
    sun = np.clip((cos_to_sun - 0.9995) / 0.0005, 0.0, 1.0)[..., None] * np.array(
        [900.0, 850.0, 750.0]
    )
    glow = np.clip(cos_to_sun, 0.0, 1.0)[..., None] ** 64 * np.array([3.0, 2.6, 2.0])
    return (sky + glow + sun).astype(np.float32)
