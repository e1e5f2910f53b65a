"""Built-in brute scenes as scene-DSL text.

Three scenes in the style of the reference's brute-force benchmarks
(SURVEY §6: 1000×1000, 10 bounces), written out here so that the port's
smoke run and tests need no scene files:

- ``CORNELL``: a box of five diffuse walls (red left, green right), a quad
  area light with emit 30 and two boxes built from quads — 16 quads, 32
  triangles.
- ``CORNELL_PLUS``: the same box plus a glass sphere (ior 1.5) and a mirror
  sphere (metallicity 1).
- ``SPHERES``: a radius-10000 ground, an emissive radius-40000 sun with
  emit 40, a blue sky, one metal ball and one glass ball.

Each ``image`` line is the full-size configuration: 1000×1000, 100 rays per
pixel, 10 bounces, exposure 1. Callers shrink it with config overrides.

``MESH_SCENES`` holds the mesh scenes, kept apart from ``SCENES`` (whose
entries all fit the brute shade kernel): a procedural torus at the
teapot's scale, 126,000 triangles (SURVEY §6), on a ground quad, diffuse
and metallic (``torus``) or glass with ior 1.5 (``glass_torus``, the
glass_teapot analogue, so refraction and total internal reflection run on
the mesh path). Each is a function of ``size`` = (segments around the ring,
segments around the tube), 2 · size[0] · size[1] triangles; ``SMALL`` is a
test size above the 512-triangle packet threshold. ``parse_mesh_scene``
parses one and gives it the substitute sky the teapot scenes get in this
checkout (``procedural.substitute_envmap``; the real ``envmap.pfm`` is not
in the repository), without a missing-file warning.
"""

from __future__ import annotations

import numpy as np

from cuda_raytracer_tpu_torch.models import procedural, scene_dsl


def _box(material: str, x0: float, x1: float, z0: float, z1: float, h: float) -> str:
    """Four side quads and a top quad of an axis-aligned box on the floor."""
    quads = [
        (x0, 0, z0, x1, 0, z0, x1, h, z0, x0, h, z0),
        (x1, 0, z0, x1, 0, z1, x1, h, z1, x1, h, z0),
        (x1, 0, z1, x0, 0, z1, x0, h, z1, x1, h, z1),
        (x0, 0, z1, x0, 0, z0, x0, h, z0, x0, h, z1),
        (x0, h, z0, x1, h, z0, x1, h, z1, x0, h, z1),
    ]
    return "".join(
        f"quad {material} " + " ".join(f"{v:g}" for v in q) + "\n" for q in quads
    )


_CORNELL_BOX = (
    "material light diffuse 0 0 0 specular 0 0 0 emit 30 30 30\n"
    "material white diffuse 0.73 0.73 0.73\n"
    "material red diffuse 0.65 0.05 0.05\n"
    "material green diffuse 0.12 0.45 0.15\n"
    "quad white -1 0 -1 1 0 -1 1 0 1 -1 0 1\n"
    "quad white -1 2 -1 -1 2 1 1 2 1 1 2 -1\n"
    "quad white -1 0 1 1 0 1 1 2 1 -1 2 1\n"
    "quad red -1 0 -1 -1 0 1 -1 2 1 -1 2 -1\n"
    "quad green 1 0 -1 1 2 -1 1 2 1 1 0 1\n"
    "quad light -0.25 1.999 -0.25 0.25 1.999 -0.25 0.25 1.999 0.25 -0.25 1.999 0.25\n"
    + _box("white", -0.6, -0.1, 0.1, 0.6, 1.2)
    + _box("white", 0.1, 0.6, -0.5, 0.0, 0.6)
)

_CORNELL_VIEW = (
    "camera position 0 1 -3.5 forward 0 0 1 up 0 1 0 fov 40\n"
    "image 1000 1000 100 10 1\n"
)

CORNELL = _CORNELL_BOX + _CORNELL_VIEW

CORNELL_PLUS = (
    _CORNELL_BOX
    + "material glass ior 1.5\n"
    "material mirror specular 0.9 0.9 0.9 metallicity 1\n"
    "sphere glass 0.35 0.8 -0.25 0.2\n"
    "sphere mirror -0.55 0.25 -0.45 0.25\n"
    + _CORNELL_VIEW
)

SPHERES = (
    "material ground diffuse 0.8 0.8 0.6\n"
    "material sun diffuse 0 0 0 specular 0 0 0 emit 40 40 40\n"
    "material metal specular 0.9 0.9 0.9 metallicity 1 roughness 0.05\n"
    "material glass ior 1.5\n"
    "sphere ground 0 -10000 0 10000\n"
    "sphere sun 0 150000 200000 40000\n"
    "sphere metal 1.2 1 0 1\n"
    "sphere glass -1.2 1 0 1\n"
    "sky 0.2 0.4 0.9\n"
    "camera position 0 1.5 -6 forward 0 -0.1 1 up 0 1 0 fov 50\n"
    "image 1000 1000 100 10 1\n"
)

SCENES = {"cornell": CORNELL, "cornell_plus": CORNELL_PLUS, "spheres": SPHERES}


FULL_SIZE = (252, 250)  # 126,000 triangles: the teapot's count
SMALL = (24, 16)  # 768 triangles

_TORUS_MAJOR = 1.0
_TORUS_MINOR = 0.4
_TORUS_LIFT = 0.5  # height of the ring's centre plane above the ground


def _torus_triangles(material: str, size) -> str:
    """``triangle`` lines of a torus around the vertical axis, wound so
    cross(e2, e1) points out of the tube."""
    n_ring, n_tube = size
    u = 2.0 * np.pi * np.arange(n_ring + 1) / n_ring
    v = 2.0 * np.pi * np.arange(n_tube + 1) / n_tube
    uu, vv = np.meshgrid(u, v, indexing="ij")
    radius = _TORUS_MAJOR + _TORUS_MINOR * np.cos(vv)
    pts = np.stack([radius * np.cos(uu), _TORUS_LIFT + _TORUS_MINOR * np.sin(vv),
                    radius * np.sin(uu)], axis=-1).astype(np.float32)
    p00, p10 = pts[:-1, :-1], pts[1:, :-1]
    p01, p11 = pts[:-1, 1:], pts[1:, 1:]
    tris = np.concatenate([
        np.concatenate([p00, p11, p01], axis=-1).reshape(-1, 9),
        np.concatenate([p00, p10, p11], axis=-1).reshape(-1, 9),
    ])
    head = f"triangle {material} "
    return "".join(head + " ".join(f"{x:.6f}" for x in row) + "\n" for row in tris)


_MESH_VIEW = (
    "material ground diffuse 0.6 0.6 0.55\n"
    "quad ground -20 0 -20 20 0 -20 20 0 20 -20 0 20\n"
    "camera position 0 2.2 -3.6 forward 0 -0.5 1 up 0 1 0 fov 45\n"
    "image 1000 1000 100 10 1\n"
)


def torus(size=FULL_SIZE) -> str:
    """Diffuse-metallic torus on a ground quad."""
    return (
        "material torus diffuse 0.75 0.35 0.2 specular 0.9 0.8 0.7 "
        "metallicity 0.3 roughness 0.2\n"
        + _torus_triangles("torus", size) + _MESH_VIEW
    )


def glass_torus(size=FULL_SIZE) -> str:
    """Glass (ior 1.5) torus on a ground quad."""
    return "material glass ior 1.5\n" + _torus_triangles("glass", size) + _MESH_VIEW


MESH_SCENES = {"torus": torus, "glass_torus": glass_torus}


def parse_mesh_scene(name: str, size=FULL_SIZE) -> scene_dsl.ParsedScene:
    """Parse ``MESH_SCENES[name](size)`` and set the substitute sky."""
    parsed = scene_dsl.parse_scene_text(MESH_SCENES[name](size), filename=name)
    parsed.environment_map = procedural.substitute_envmap()
    return parsed
