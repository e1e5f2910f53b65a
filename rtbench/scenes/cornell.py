"""The Cornell box as scene text: five diffuse walls (red left, green right),
a quad area light of emit 30 under the ceiling and two boxes on the floor,
16 quads (32 triangles), black outside, viewed through the open front.

The seed sets the two boxes' diffuse albedo, drawn uniformly from the
range in ``params``; the camera stays where ``params`` puts it. So every
seed traces the same paths, and only the light they carry differs: a
camera moved by the seed moved the image's work with it.
"""

from __future__ import annotations

import numpy as np

OBJECT_MATERIAL = "box"


def _box(material: str, x0: float, x1: float, z0: float, z1: float, h: float) -> str:
    quads = [
        (x0, 0, z0, x1, 0, z0, x1, h, z0, x0, h, z0),
        (x1, 0, z0, x1, 0, z1, x1, h, z1, x1, h, z0),
        (x1, 0, z1, x0, 0, z1, x0, h, z1, x1, h, z1),
        (x0, 0, z1, x0, 0, z0, x0, h, z0, x0, h, z1),
        (x0, h, z0, x1, h, z0, x1, h, z1, x0, h, z1),
    ]
    return "".join(f"quad {material} " + " ".join(f"{v:g}" for v in q) + "\n" for q in quads)


def generate(params: dict, rng: np.random.Generator):
    """→ (scene text without its ``image`` line, {} — no files)."""
    cam = params["camera"]
    albedo = rng.uniform(params["albedo_low"], params["albedo_high"])
    position = np.asarray(cam["position"], np.float64)
    forward = np.asarray(cam["target"], np.float64) - position
    vec = " ".join
    text = (
        "material light diffuse 0 0 0 specular 0 0 0 emit 30 30 30\n"
        "material white diffuse 0.73 0.73 0.73\n"
        "material red diffuse 0.65 0.05 0.05\n"
        "material green diffuse 0.12 0.45 0.15\n"
        f"material {OBJECT_MATERIAL} diffuse {vec(f'{a:.6f}' for a in albedo)}\n"
        "quad white -1 0 -1 1 0 -1 1 0 1 -1 0 1\n"
        "quad white -1 2 -1 -1 2 1 1 2 1 1 2 -1\n"
        "quad white -1 0 1 1 0 1 1 2 1 -1 2 1\n"
        "quad red -1 0 -1 -1 0 1 -1 2 1 -1 2 -1\n"
        "quad green 1 0 -1 1 2 -1 1 2 1 1 0 1\n"
        "quad light -0.25 1.999 -0.25 0.25 1.999 -0.25 0.25 1.999 0.25 -0.25 1.999 0.25\n"
        + _box(OBJECT_MATERIAL, -0.6, -0.1, 0.1, 0.6, 1.2)
        + _box(OBJECT_MATERIAL, 0.1, 0.6, -0.5, 0.0, 0.6)
        + f"camera position {vec(f'{x:.9g}' for x in position)} "
        f"forward {vec(f'{x:.9g}' for x in forward)} up 0 1 0 fov {cam['fov']}\n"
    )
    return text, {}
