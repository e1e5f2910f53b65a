"""The teapot-scale torus in glass under a procedural sky, as scene text.

The geometry, the ground quad, the camera and the sky are ``torus.py``'s
(loaded beside this file): a torus of ``ring`` × ``tube`` segments, two
triangles each (252 × 250 = 126,000, the upstream teapot's count), on a
40 × 40 ground quad, under a horizon gradient with a sun disc written as a
PFM beside the text. The whole torus is one dielectric of ior 1.5
(``material glass ... ior 1.5``), so refracted paths start inside the mesh
and leave it through its far side.

The seed sets the sun's direction (azimuth and elevation, drawn first and
in the same order as ``torus.py`` draws them) and the glass's transmission
tint (its diffuse colour, the weight a refracted path carries), each drawn
uniformly from the ranges in ``params``; the camera stays where ``params``
puts it. So every seed asks for the same triangles and the same paths, and
only the light they carry differs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rtbench.core.spec import load_module

OBJECT_MATERIAL = "glass"
IOR = 1.5

_torus = load_module(Path(__file__).with_name("torus.py"))


def generate(params: dict, rng: np.random.Generator):
    """→ (scene text without its ``image`` line, {file name: sky map})."""
    cam = params["camera"]
    sun_azimuth = np.deg2rad(rng.uniform(*params["sun_azimuth_deg"]))
    sun_elevation = np.deg2rad(rng.uniform(*params["sun_elevation_deg"]))
    tint = rng.uniform(params["tint_low"], params["tint_high"])
    position = np.asarray(cam["position"], np.float64)
    forward = np.asarray(cam["target"], np.float64) - position
    vec = " ".join
    text = (
        f"material {OBJECT_MATERIAL} diffuse {vec(f'{a:.6f}' for a in tint)} ior {IOR}\n"
        + _torus._triangles(OBJECT_MATERIAL, params["ring"], params["tube"])
        + "material ground diffuse 0.6 0.6 0.55\n"
        "quad ground -20 0 -20 20 0 -20 20 0 20 -20 0 20\n"
        "sky_map sky.pfm\n"
        f"camera position {vec(f'{x:.9g}' for x in position)} "
        f"forward {vec(f'{x:.9g}' for x in forward)} up 0 1 0 fov {cam['fov']}\n"
    )
    return text, {"sky.pfm": _torus.sky(params["sky_size"], sun_azimuth, sun_elevation)}
