"""The final scene of *Ray Tracing in One Weekend* (v4, "A Final Render",
``main.cc``) as scene text: a radius-1000 ground sphere, a grid of small
random spheres and three large ones, every sphere with a material of its
own, under the book's sky gradient.

The layout follows the book's rules, drawn from ``params["layout_seed"]``:
for each candidate of a ``grid`` × ``grid`` square (a and b from
``grid_lo``), a material draw and a centre ``(a + 0.9 u, 0.2, b + 0.9 v)``
of radius 0.2; a candidate within 0.9 of (4, 0.2, 0) is skipped; a draw
under 0.8 is Lambertian, under 0.95 metal with a fuzz from U(0, 0.5), else
glass of ior 1.5. Then glass at (0, 1, 0), Lambertian (0.4, 0.2, 0.1) at
(-4, 1, 0) and metal (0.7, 0.6, 0.5) of fuzz 0 at (4, 1, 0), radius 1.

The run's seed draws only the small spheres' albedos, in the book's
ranges: a Lambertian's ``U · U`` per channel, a metal's U(0.5, 1). So
every seed asks for the same spheres, rays and paths, and only the light
they carry differs, but for a path whose throughput, a product of dark
albedos, underflows to 0 and ends it early: the live ray-bounces of two
seeds differ by a few in 10⁴.

In the scene language a Lambertian is ``diffuse`` with metallicity 0, a
metal ``specular`` with metallicity 1 and its fuzz as ``roughness``, glass
``ior 1.5`` with white diffuse and specular. The camera's right vector is
``up × forward`` there, the mirror of the book's, so the world is written
mirrored in z (z → -z): the image is the book's and not its mirror. Its up
vector is the book's ``vup`` made square to the view, so the image plane
is the book's pinhole plane. The sky, ``(1 - a) (1, 1, 1) + a (0.5, 0.7,
1)`` with ``a = (dir.y + 1) / 2``, is written as an equal-area map (the
layout the renderer samples, its +z the world's up) in a PFM beside the
text.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rtbench.core.spec import load_module

IOR = 1.5
SMALL_RADIUS = 0.2
SKIP_CENTER = np.array([4.0, 0.2, 0.0])
SKIP_RADIUS = 0.9
DIFFUSE_SHARE, METAL_SHARE = 0.8, 0.15  # the rest glass
FUZZ_HIGH = 0.5
HORIZON, ZENITH = np.array([1.0, 1.0, 1.0]), np.array([0.5, 0.7, 1.0])
# The three large spheres: (kind, centre, radius, albedo, fuzz).
LARGE = (("glass", (0.0, 1.0, 0.0), 1.0, None, None),
         ("diffuse", (-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), None),
         ("metal", (4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0))
GROUND = ("diffuse", (0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), None)

_torus = load_module(Path(__file__).with_name("torus.py"))


def layout(params: dict) -> list:
    """The spheres of ``params["layout_seed"]`` in scene order, ground first:
    [(kind, centre, radius, fixed albedo or None, fuzz or None)], in the
    book's coordinates (not mirrored)."""
    rng = np.random.default_rng(params["layout_seed"])
    lo, n = params["grid_lo"], params["grid"]
    spheres = [GROUND]
    for a in range(lo, lo + n):
        for b in range(lo, lo + n):
            choose = rng.random()
            u, v = rng.random(), rng.random()
            centre = np.array([a + 0.9 * u, SMALL_RADIUS, b + 0.9 * v])
            if np.linalg.norm(centre - SKIP_CENTER) <= SKIP_RADIUS:
                continue
            if choose < DIFFUSE_SHARE:
                spheres.append(("diffuse", tuple(centre), SMALL_RADIUS, None, None))
            elif choose < DIFFUSE_SHARE + METAL_SHARE:
                fuzz = rng.uniform(0.0, FUZZ_HIGH)
                spheres.append(("metal", tuple(centre), SMALL_RADIUS, None, fuzz))
            else:
                spheres.append(("glass", tuple(centre), SMALL_RADIUS, None, None))
    return spheres + list(LARGE)


def sky(size: int) -> np.ndarray:
    """(size, size, 3) float32: the book's gradient, in the equal-area
    layout the renderer samples (the map's +z is up)."""
    ys, xs = np.meshgrid((np.arange(size) + 0.5) / size, (np.arange(size) + 0.5) / size,
                         indexing="ij")
    a = 0.5 * (_torus._square_to_sphere(xs, ys)[..., 2] + 1.0)
    return ((1.0 - a)[..., None] * HORIZON + a[..., None] * ZENITH).astype(np.float32)


def _camera(cam: dict) -> tuple:
    """(position, forward, up) in the mirrored world: the book's lookfrom,
    lookat and vup with z negated, the up vector made square to forward."""
    flip = np.array([1.0, 1.0, -1.0])
    position = np.asarray(cam["lookfrom"], np.float64) * flip
    forward = np.asarray(cam["lookat"], np.float64) * flip - position
    forward /= np.linalg.norm(forward)
    up = np.asarray(cam["vup"], np.float64)
    up = up - (up @ forward) * forward
    return position, forward, up / np.linalg.norm(up)


def generate(params: dict, rng: np.random.Generator):
    """→ (scene text without its ``image`` line, {file name: sky map})."""
    vec = " ".join
    lines = []
    for i, (kind, centre, radius, albedo, fuzz) in enumerate(layout(params)):
        name = f"m{i}"
        if kind == "glass":
            lines.append(f"material {name} diffuse 1 1 1 specular 1 1 1 ior {IOR}\n")
        elif kind == "diffuse":
            colour = albedo if albedo is not None else rng.random(3) * rng.random(3)
            lines.append(f"material {name} diffuse {vec(f'{c:.6f}' for c in colour)} "
                         "metallicity 0\n")
        else:
            colour = albedo if albedo is not None else rng.uniform(0.5, 1.0, 3)
            lines.append(f"material {name} specular {vec(f'{c:.6f}' for c in colour)} "
                         f"metallicity 1 roughness {fuzz:.6f}\n")
        x, y, z = centre
        lines.append(f"sphere {name} {x:.6f} {y:.6f} {0.0 - z:.6f} {radius:g}\n")
    cam = params["camera"]
    position, forward, up = _camera(cam)
    lines.append("sky_map sky.pfm\n")
    lines.append(f"camera position {vec(f'{x:.9g}' for x in position)} "
                 f"forward {vec(f'{x:.9g}' for x in forward)} "
                 f"up {vec(f'{x:.9g}' for x in up)} fov {cam['vfov']}\n")
    return "".join(lines), {"sky.pfm": sky(params["sky_size"])}
