"""The teapot-scale torus under a procedural sky, as scene text.

A torus around the vertical axis (major radius 1, minor radius 0.4, its
ring's plane 0.5 above the ground), ``ring`` × ``tube`` segments, two
triangles each (252 × 250 = 126,000, the upstream teapot's count), wound
so cross(e2, e1) points out of the tube, on a 40 × 40 ground quad. The sky
is a horizon gradient with a sun disc, in the equal-area octahedral
layout the renderer samples, written as a PFM beside the text.

The seed sets the sun's direction (azimuth and elevation) and the
torus's diffuse albedo, each drawn uniformly from the ranges in
``params``; the camera stays where ``params`` puts it. So every seed asks
for the same triangles, rays and paths, and only the light they carry
differs: a camera moved by the seed moved the image's work with it.
"""

from __future__ import annotations

import numpy as np

OBJECT_MATERIAL = "torus"


def _triangles(material: str, n_ring: int, n_tube: int) -> str:
    u = 2.0 * np.pi * np.arange(n_ring + 1) / n_ring
    v = 2.0 * np.pi * np.arange(n_tube + 1) / n_tube
    uu, vv = np.meshgrid(u, v, indexing="ij")
    radius = 1.0 + 0.4 * np.cos(vv)
    pts = np.stack([radius * np.cos(uu), 0.5 + 0.4 * np.sin(vv), radius * np.sin(uu)],
                   axis=-1).astype(np.float32)
    p00, p10 = pts[:-1, :-1], pts[1:, :-1]
    p01, p11 = pts[:-1, 1:], pts[1:, 1:]
    tris = np.concatenate([np.concatenate([p00, p11, p01], axis=-1).reshape(-1, 9),
                           np.concatenate([p00, p10, p11], axis=-1).reshape(-1, 9)])
    head = f"triangle {material} "
    return "".join(head + " ".join(f"{x:.6f}" for x in row) + "\n" for row in tris)


def _square_to_sphere(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Inverse of the equal-area sphere → square map, on [0, 1]² grids."""
    up, vp = 2.0 * u - 1.0, 2.0 * v - 1.0
    au, av = np.abs(up), np.abs(vp)
    sd = 1.0 - (au + av)
    r = 1.0 - np.abs(sd)
    phi = np.where(r == 0, 1.0, (av - au) / np.where(r == 0, 1.0, r) + 1.0) * (np.pi / 4.0)
    z = np.copysign(1.0 - r * r, sd)
    scale = r * np.sqrt(np.maximum(2.0 - r * r, 0.0))
    return np.stack([np.copysign(np.cos(phi), up) * scale,
                     np.copysign(np.sin(phi), vp) * scale, z], axis=-1)


def sky(size: int, sun_azimuth: float, sun_elevation: float) -> np.ndarray:
    """(size, size, 3) float32 HDR sky: zenith-to-horizon gradient, a dim
    ground, a sun disc and its glow, the sun at the given angles (radians;
    the map's +z is up)."""
    ys, xs = np.meshgrid((np.arange(size) + 0.5) / size, (np.arange(size) + 0.5) / size,
                         indexing="ij")
    dirs = _square_to_sphere(xs, ys)
    elevation = dirs[..., 2]
    horizon = np.clip(1.0 - np.abs(elevation), 0.0, 1.0) ** 3
    upper = np.array([0.35, 0.52, 0.95]) * (1 - horizon[..., None]) \
        + np.array([0.85, 0.85, 0.92]) * horizon[..., None]
    ground = np.array([0.28, 0.25, 0.22]) * (0.4 + 0.6 * horizon[..., None])
    out = np.where(elevation[..., None] >= 0, upper, ground)
    sun = np.array([np.cos(sun_elevation) * np.cos(sun_azimuth),
                    np.cos(sun_elevation) * np.sin(sun_azimuth), np.sin(sun_elevation)])
    cos_sun = dirs @ sun
    out = out + np.clip(cos_sun, 0.0, 1.0)[..., None] ** 64 * np.array([3.0, 2.6, 2.0])
    out = out + np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0)[..., None] \
        * np.array([900.0, 850.0, 750.0])
    return out.astype(np.float32)


def generate(params: dict, rng: np.random.Generator):
    """→ (scene text without its ``image`` line, {file name: sky map})."""
    cam = params["camera"]
    sun_azimuth = np.deg2rad(rng.uniform(*params["sun_azimuth_deg"]))
    sun_elevation = np.deg2rad(rng.uniform(*params["sun_elevation_deg"]))
    albedo = rng.uniform(params["albedo_low"], params["albedo_high"])
    position = np.asarray(cam["position"], np.float64)
    forward = np.asarray(cam["target"], np.float64) - position
    vec = " ".join
    text = (
        f"material {OBJECT_MATERIAL} diffuse {vec(f'{a:.6f}' for a in albedo)} "
        "specular 0.9 0.8 0.7 metallicity 0.3 roughness 0.2\n"
        + _triangles(OBJECT_MATERIAL, params["ring"], params["tube"])
        + "material ground diffuse 0.6 0.6 0.55\n"
        "quad ground -20 0 -20 20 0 -20 20 0 20 -20 0 20\n"
        "sky_map sky.pfm\n"
        f"camera position {vec(f'{x:.9g}' for x in position)} "
        f"forward {vec(f'{x:.9g}' for x in forward)} up 0 1 0 fov {cam['fov']}\n"
    )
    return text, {"sky.pfm": sky(params["sky_size"], sun_azimuth, sun_elevation)}
