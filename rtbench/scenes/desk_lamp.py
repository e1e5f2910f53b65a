"""An articulated desk lamp in a simple room, lit by an emissive mesh inside
a glass bulb, as scene text.

The upstream lamp scene (51 meshes, about 619,000 triangles) is not in the
repository, so this is a procedural lamp of the same count and the same
make-up: a 20 x 20 floor and a 20 x 10 wall (two triangles each) around a
lamp about 0.8 units tall whose triangles lie in a box of about 1.3 units:

- base: a capped cylinder (r 0.2, h 0.04), black_metal; 252 segments
  around, 3 rings of side and 3 of each cap: 4,032 triangles;
- arms: 4 open tubes (r 0.008, 0.45 long) in two pairs, black_metal; 25
  around, 325 along: 65,000;
- springs: 2 helical wire tubes (wire 0.003, coil 0.012, 40 turns), one
  between each pair, chrome; 10 around the wire, 3,275 along: 131,000;
- joints: 6 tori (0.018, 0.006) at the pairs' ends, chrome; 80 around, 26
  around the tube: 24,960;
- shade: a bell of revolution 0.28 long, r 0.045 to 0.14, its opening
  facing down and forwards: an outer wall, a rim and a top disc in
  black_metal, an inner wall and its top disc in reflector; 400 around,
  163 along each wall: 262,400;
- bulb: a subdivided octahedron on a sphere of r 0.05 inside the shade,
  glass (ior 1.5); 64 segments a face edge: 32,768;
- filament: a torus (0.012, 0.0025) at the bulb's centre, emitting 500 x a
  warm tint; 49 around, 21 around the tube: 2,058;
- cable: a tube of r 0.004 along a fixed curve on the floor from the base,
  cable; 12 around, 4,047 along: 97,128.

619,350 triangles in all at ``detail`` 1, the upstream's count. ``detail``
scales every segment count above, each with a floor of 3, so tests can
build the same lamp in a few thousand triangles. No two triangles are
coplanar and overlapping: the base and the cable float half a millimetre
above the floor, and the shade's walls, the bulb and the filament keep
gaps (the joints cut through the rods they hold, as pins do). The bulb's
triangles are wound so that ``cross(e2, e1)`` points out of the glass, the
side a dielectric takes as its front.

Beside the filament the only light is the sky, a constant dim blue. The camera
sees the lamp from the front and above, the lamp filling about half of the
frame's height, and every camera ray lands on the floor, the wall or the
lamp.

The seed draws the floor's and the wall's diffuse albedo and the
filament's tint, each uniformly from the ranges in ``params``; it changes
those three material lines and nothing else: every seed asks for the same
triangles, sky and camera.
"""

from __future__ import annotations

import numpy as np

OBJECT_MATERIAL = "floor"

# Segment counts of each part at detail 1 (see the list above).
SEGMENTS = {
    "base": (252, 3, 3),  # around, side rings, rings of each cap
    "arm": (25, 325),  # around, along; 4 rods
    "spring": (10, 3275),  # around the wire, along the helix; 2 springs
    "joint": (80, 26),  # around the ring, around the tube; 6 tori
    "shade": (400, 163),  # around, along each wall
    "bulb": (64,),  # segments of an octahedron face's edge
    "filament": (49, 21),  # around the ring, around the tube
    "cable": (12, 4047),  # around, along
}
ARMS, SPRINGS, JOINTS = 4, 2, 6

MATERIALS = {  # the materials the seed does not draw
    "black_metal": "diffuse 0.02 0.02 0.02 specular 0.6 0.6 0.6 metallicity 0.5 roughness 0.3",
    "chrome": "diffuse 0 0 0 specular 0.95 0.95 0.95 metallicity 1 roughness 0.05",
    "reflector": "specular 0.9 0.9 0.9 metallicity 1 roughness 0.15",
    "glass": "diffuse 1 1 1 ior 1.5",
    "cable": "diffuse 0.03 0.03 0.03",
}

# The lamp's layout (units: about a metre).
BASE_CENTRE = np.array([-0.25, 0.0005, 0.35])
BASE_RADIUS, BASE_HEIGHT = 0.2, 0.04
PIVOT_RISE = 0.07  # the lower pivot above the base's bottom
ARM_LENGTH, ARM_RADIUS, PAIR_HALF_GAP = 0.45, 0.008, 0.025
LOWER_ARM = np.array([-0.35, 0.93, 0.1])
UPPER_ARM = np.array([0.85, 0.45, -0.25])
SPRING_SPAN = (0.05, 0.41)  # along each arm, as shares of its length
SPRING_TURNS, SPRING_COIL, SPRING_WIRE = 40, 0.012, 0.003
JOINT_RING, JOINT_TUBE = 0.018, 0.006
SHADE_AXIS = np.array([0.35, -0.45, -0.82])
SHADE_LENGTH, SHADE_TOP, SHADE_MOUTH, SHADE_WALL = 0.28, 0.045, 0.14, 0.002
BULB_AT, BULB_RADIUS = 0.17, 0.05  # the bulb's centre along the shade's axis
FILAMENT_RING, FILAMENT_TUBE = 0.012, 0.0025
CABLE_RADIUS = 0.004
ROOM_HALF_WIDTH, WALL_Z, WALL_HEIGHT, FLOOR_DEPTH = 10.0, 1.0, 10.0, 20.0


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _segments(params: dict) -> dict:
    detail = float(params.get("detail", 1.0))
    return {part: tuple(max(3, int(np.floor(n * detail + 0.5))) for n in counts)
            for part, counts in SEGMENTS.items()}


def _part_counts(seg: dict) -> dict:
    a, h, r = seg["base"]
    return {
        "floor": 2, "wall": 2,
        "base": a * (2 * h + 4 * r - 2),
        "arms": ARMS * 2 * seg["arm"][0] * seg["arm"][1],
        "springs": SPRINGS * 2 * seg["spring"][0] * seg["spring"][1],
        "joints": JOINTS * 2 * seg["joint"][0] * seg["joint"][1],
        "shade": 4 * seg["shade"][0] * seg["shade"][1] + 4 * seg["shade"][0],
        "bulb": 8 * seg["bulb"][0] ** 2,
        "filament": 2 * seg["filament"][0] * seg["filament"][1],
        "cable": 2 * seg["cable"][0] * seg["cable"][1],
    }


def triangle_count(params: dict) -> int:
    """The triangles ``generate`` writes for ``params``."""
    return sum(_part_counts(_segments(params)).values())


def _grid(points: np.ndarray) -> np.ndarray:
    """(rows, around, 3) rings, each closed around → (2 (rows - 1) around, 9)."""
    a = points[:-1]
    b = np.roll(points[:-1], -1, axis=1)
    c = points[1:]
    d = np.roll(points[1:], -1, axis=1)
    return np.concatenate([np.concatenate([a, b, d], -1).reshape(-1, 9),
                           np.concatenate([a, d, c], -1).reshape(-1, 9)])


def _fan(centre, ring: np.ndarray) -> np.ndarray:
    """A disc: ``centre`` joined to each edge of the closed ``ring``."""
    c = np.broadcast_to(np.asarray(centre, np.float64), ring.shape)
    return np.concatenate([c, ring, np.roll(ring, -1, axis=0)], -1)


def _basis(axis):
    """Two unit vectors perpendicular to ``axis`` and to each other."""
    axis = _unit(axis)
    helper = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = _unit(np.cross(axis, helper))
    return u, np.cross(axis, u)


def _rings(centres: np.ndarray, radii, u: np.ndarray, v: np.ndarray, around: int):
    """Rings of ``around`` points about ``centres`` (K, 3) in the planes of
    ``u``, ``v`` (K, 3 each or 3) → (K, around, 3)."""
    theta = 2.0 * np.pi * np.arange(around) / around
    radii = np.broadcast_to(np.asarray(radii, np.float64), centres.shape[:1])[:, None, None]
    u = np.broadcast_to(u, centres.shape)[:, None, :]
    v = np.broadcast_to(v, centres.shape)[:, None, :]
    return centres[:, None, :] + radii * (np.cos(theta)[None, :, None] * u
                                          + np.sin(theta)[None, :, None] * v)


def _tube(centres: np.ndarray, radius: float, around: int, reference) -> np.ndarray:
    """An open tube about the polyline ``centres``, its rings square to the
    line, oriented by ``reference`` (a vector never along the line)."""
    tangent = _unit(np.gradient(centres, axis=0))
    ref = np.broadcast_to(np.asarray(reference, np.float64), centres.shape)
    normal = _unit(ref - np.sum(ref * tangent, -1, keepdims=True) * tangent)
    return _grid(_rings(centres, radius, normal, np.cross(tangent, normal), around))


def _torus(centre, axis, ring: float, tube: float, n_ring: int, n_tube: int) -> np.ndarray:
    u, v = _basis(axis)
    phi = 2.0 * np.pi * np.arange(n_ring) / n_ring
    theta = 2.0 * np.pi * np.arange(n_tube) / n_tube
    out = np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v  # (n_ring, 3)
    spine = np.asarray(centre, np.float64) + ring * out
    points = (spine[:, None, :] + tube * (np.cos(theta)[None, :, None] * out[:, None, :]
                                          + np.sin(theta)[None, :, None] * _unit(axis)))
    return _grid(np.concatenate([points, points[:1]]))


def _revolve(apex, axis, s: np.ndarray, r: np.ndarray, around: int) -> np.ndarray:
    """Rings of radius ``r`` at ``s`` along ``axis`` from ``apex`` → (K, around, 3)."""
    axis = _unit(axis)
    u, v = _basis(axis)
    return _rings(np.asarray(apex, np.float64) + s[:, None] * axis, r, u, v, around)


def _sphere(centre, radius: float, n: int) -> np.ndarray:
    """A sphere from the octahedron's 8 faces, each cut into n^2 triangles,
    every vertex pushed onto the sphere; wound so cross(e2, e1) points out."""
    tris = []
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                a, b, c = np.diag([sx, sy, sz])

                def point(i, j):
                    return (i * b + j * c + (n - i - j) * a) / n

                for i in range(n):
                    for j in range(n - i):
                        tris.append((point(i, j), point(i + 1, j), point(i, j + 1)))
                        if i + j <= n - 2:
                            tris.append((point(i + 1, j), point(i + 1, j + 1), point(i, j + 1)))
    p = np.asarray(tris)  # (8 n^2, 3, 3) on the octahedron
    p = _unit(p) * radius
    outward = np.sum(np.cross(p[:, 2] - p[:, 0], p[:, 1] - p[:, 0]) * p.mean(axis=1), -1) > 0
    p[~outward] = p[~outward][:, [0, 2, 1]]
    return (p + np.asarray(centre, np.float64)).reshape(-1, 9)


def layout():
    """The lamp's joints: pivot, elbow, head; the arms' directions; the
    pairs' lateral direction; the shade's axis."""
    d1, d2 = _unit(LOWER_ARM), _unit(UPPER_ARM)
    pivot = BASE_CENTRE + np.array([0.0, PIVOT_RISE, 0.0])
    elbow = pivot + ARM_LENGTH * d1
    head = elbow + ARM_LENGTH * d2
    lateral = _unit(np.cross(d1, d2))
    return pivot, elbow, head, d1, d2, lateral, _unit(SHADE_AXIS)


def parts(params: dict):
    """[(part, material, (T, 9) float64 triangles)] of the lamp and room."""
    seg = _segments(params)
    pivot, elbow, head, d1, d2, lateral, axis = layout()
    up = np.array([0.0, 1.0, 0.0])
    out = []
    w, z, depth = ROOM_HALF_WIDTH, WALL_Z, FLOOR_DEPTH
    floor = np.array([[-w, 0, z - depth], [w, 0, z - depth], [w, 0, z], [-w, 0, z]])
    wall = np.array([[-w, 0, z], [w, 0, z], [w, WALL_HEIGHT, z], [-w, WALL_HEIGHT, z]])
    for name, q in (("floor", floor), ("wall", wall)):
        out.append((name, name, np.stack([np.concatenate([q[0], q[1], q[2]]),
                                          np.concatenate([q[0], q[2], q[3]])])))

    around, side, cap = seg["base"]
    heights = BASE_CENTRE[1] + BASE_HEIGHT * np.arange(side + 1) / side
    wall_rings = _revolve(BASE_CENTRE, up, heights - BASE_CENTRE[1],
                          np.full(side + 1, BASE_RADIUS), around)
    base = [_grid(wall_rings)]
    for level, ring_at in ((0.0, wall_rings[0]), (BASE_HEIGHT, wall_rings[-1])):
        radii = BASE_RADIUS * np.arange(1, cap + 1) / cap
        rings = _revolve(BASE_CENTRE, up, np.full(cap, level), radii, around)
        rings[-1] = ring_at
        base += [_fan(BASE_CENTRE + level * up, rings[0]), _grid(rings)]
    out.append(("base", "black_metal", np.concatenate(base)))

    rod_around, rod_along = seg["arm"]
    steps = np.linspace(0.0, ARM_LENGTH, rod_along + 1)[:, None]
    rods = [_tube(start + side * PAIR_HALF_GAP * lateral + steps * d, ARM_RADIUS, rod_around,
                  lateral)
            for start, d in ((pivot, d1), (elbow, d2)) for side in (-1.0, 1.0)]
    out.append(("arms", "black_metal", np.concatenate(rods)))

    wire_around, wire_along = seg["spring"]
    t = np.linspace(0.0, 1.0, wire_along + 1)[:, None]
    springs = []
    for start, d in ((pivot, d1), (elbow, d2)):
        u, v = _basis(d)
        lo, hi = SPRING_SPAN
        phi = 2.0 * np.pi * SPRING_TURNS * t
        helix = (start + ARM_LENGTH * (lo + (hi - lo) * t) * d
                 + SPRING_COIL * (np.cos(phi) * u + np.sin(phi) * v))
        springs.append(_tube(helix, SPRING_WIRE, wire_around, d))
    out.append(("springs", "chrome", np.concatenate(springs)))

    n_ring, n_tube = seg["joint"]
    joints = [_torus(at + side * PAIR_HALF_GAP * lateral, lateral, JOINT_RING, JOINT_TUBE,
                     n_ring, n_tube)
              for at in (pivot, elbow, head) for side in (-1.0, 1.0)]
    out.append(("joints", "chrome", np.concatenate(joints)))

    around, along = seg["shade"]
    s = SHADE_LENGTH * np.arange(along + 1) / along
    s_in = SHADE_WALL + (SHADE_LENGTH - SHADE_WALL) * np.arange(along + 1) / along

    def radius(at):
        return SHADE_TOP + (SHADE_MOUTH - SHADE_TOP) * (at / SHADE_LENGTH) ** 1.6

    outer = _revolve(head, axis, s, radius(s), around)
    inner = _revolve(head, axis, s_in, radius(s_in) - SHADE_WALL, around)
    out.append(("shade_outer", "black_metal",
                np.concatenate([_grid(outer), _grid(np.stack([outer[-1], inner[-1]])),
                                _fan(head, outer[0])])))
    out.append(("shade_inner", "reflector",
                np.concatenate([_grid(inner), _fan(head + SHADE_WALL * axis, inner[0])])))

    bulb_centre = head + BULB_AT * axis
    out.append(("bulb", "glass", _sphere(bulb_centre, BULB_RADIUS, seg["bulb"][0])))
    out.append(("filament", "filament",
                _torus(bulb_centre, axis, FILAMENT_RING, FILAMENT_TUBE, *seg["filament"])))

    cable_around, cable_along = seg["cable"]
    t = np.linspace(0.0, 1.0, cable_along + 1)
    start = BASE_CENTRE + np.array([BASE_RADIUS, 0.0, 0.0])
    curve = np.stack([start[0] + 0.85 * t,
                      np.full_like(t, CABLE_RADIUS + 0.0005),
                      start[2] - 0.25 * t + 0.12 * np.sin(3.0 * np.pi * t)], axis=-1)
    out.append(("cable", "cable", _tube(curve, CABLE_RADIUS, cable_around, up)))
    return out


def _triangle_lines(material: str, tris: np.ndarray) -> str:
    row = f"triangle {material} " + " ".join(["%.6f"] * 9) + "\n"
    return "".join(row % tuple(r) for r in tris.tolist())


def _vec(v) -> str:
    return " ".join(f"{x:.6f}" for x in v)


def generate(params: dict, rng: np.random.Generator):
    """→ (scene text without its ``image`` line, {}: the scene has no files)."""
    floor = rng.uniform(params["albedo_low"], params["albedo_high"])
    wall = rng.uniform(params["albedo_low"], params["albedo_high"])
    tint = rng.uniform(params["filament_tint_low"], params["filament_tint_high"])
    cam = params["camera"]
    position = np.asarray(cam["position"], np.float64)
    forward = np.asarray(cam["target"], np.float64) - position
    head = [
        f"material floor diffuse {_vec(floor)}",
        f"material wall diffuse {_vec(wall)}",
        *(f"material {name} {props}" for name, props in MATERIALS.items()),
        f"material filament diffuse 0 0 0 specular 0 0 0 emit {_vec(params['emit'] * tint)}",
        f"sky {' '.join(str(x) for x in params['sky'])}",
        f"camera position {' '.join(f'{x:.9g}' for x in position)} "
        f"forward {' '.join(f'{x:.9g}' for x in forward)} up 0 1 0 fov {cam['fov']}",
    ]
    body = "".join(_triangle_lines(material, tris) for _, material, tris in parts(params))
    return "\n".join(head) + "\n" + body, {}
