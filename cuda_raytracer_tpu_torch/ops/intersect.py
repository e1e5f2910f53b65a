"""Ray-primitive intersection (counterpart of ``cuda_raytracer_tpu/ops/intersect.py``).

Batched over a leading ray axis and vectorised over primitives as (rays x
prims) tiles. Epsilons and acceptance rules match the reference: hit
distance >= 0.005, strict closest-hit comparisons, first index wins ties.
``ray_aabb`` is the BVH walk's slab test (``ops/traverse.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cuda_raytracer_tpu_torch.ops import vecmath

HIT_EPS = 0.005
MISS = 1e30


def intersect_spheres(
    origin: torch.Tensor,  # (R, 3)
    direction: torch.Tensor,  # (R, 3)
    center: torch.Tensor,  # (S, 3)
    radius: torch.Tensor,  # (S,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest sphere hit per ray, brute force over all spheres.
    Quarter-discriminant quadratic; near root first, then far root.

    Returns (t, index): t == MISS and index == -1 when nothing is hit."""
    offx = center[None, :, 0] - origin[:, 0:1]
    offy = center[None, :, 1] - origin[:, 1:2]
    offz = center[None, :, 2] - origin[:, 2:3]
    minus_half_b = (
        offx * direction[:, 0:1] + offy * direction[:, 1:2] + offz * direction[:, 2:3]
    )
    quarter_c = (
        offx * offx + offy * offy + offz * offz
        - radius[None, :] * radius[None, :]
    )
    quarter_disc = minus_half_b * minus_half_b - quarter_c
    ok = quarter_disc >= 0
    half_sqrt = torch.sqrt(torch.clamp_min(quarter_disc, 0.0))
    near = minus_half_b - half_sqrt
    far = minus_half_b + half_sqrt
    t = torch.where(near >= HIT_EPS, near, torch.where(far >= HIT_EPS, far, MISS))
    t = torch.where(ok, t, MISS)  # (R, S)
    return _closest(t)


def _closest(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_t, index | -1) per row of a (R, N) hit-distance matrix; the
    first minimum wins ties."""
    N = t.shape[1]
    best_t = torch.amin(t, dim=1)
    eq = t == best_t[:, None]
    cols = torch.arange(N, dtype=torch.int32, device=t.device)[None, :]
    idx = torch.amin(torch.where(eq, cols, N), dim=1)
    hit = best_t < MISS
    index = torch.where(hit, idx, -1).to(torch.int32)
    return torch.where(hit, best_t, MISS), index


def moller_trumbore(
    origin: torch.Tensor,  # (..., 3)
    direction: torch.Tensor,  # (..., 3)
    p1: torch.Tensor,  # (..., 3)
    e1: torch.Tensor,  # (..., 3)  p2 - p1
    e2: torch.Tensor,  # (..., 3)  p3 - p1
) -> torch.Tensor:
    """Möller–Trumbore hit distance for broadcast-matched ray/triangle
    batches; MISS where the ray misses. Rejects a zero determinant, u
    outside [0,1], v < 0, u+v > 1 and t < 0.005."""
    h = vecmath.cross(direction, e2)
    det = vecmath.dot(h, e1)
    zero = det == 0
    inv_det = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, det))
    offset = origin - p1
    u = vecmath.dot(offset, h) * inv_det
    q = vecmath.cross(offset, e1)
    v = vecmath.dot(direction, q) * inv_det
    t = vecmath.dot(e2, q) * inv_det
    valid = (
        (det != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
        & (t >= HIT_EPS)
    )
    return torch.where(valid, t, MISS)


def intersect_triangles_brute(
    origin: torch.Tensor,  # (R, 3)
    direction: torch.Tensor,  # (R, 3)
    p1: torch.Tensor,  # (T, 3)
    e1: torch.Tensor,  # (T, 3)
    e2: torch.Tensor,  # (T, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest triangle hit per ray over all triangles as one (R, T) tile.
    Returns (t, triangle_index | -1). Component form: per-axis (R, 1) ×
    (1, T) broadcasts, in the JAX expression order."""
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    p1x, p1y, p1z = p1[None, :, 0], p1[None, :, 1], p1[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    # h = d × e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = hx * e1x + hy * e1y + hz * e1z
    zero = det == 0
    inv_det = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, det))
    fx = ox - p1x
    fy = oy - p1y
    fz = oz - p1z
    u = (fx * hx + fy * hy + fz * hz) * inv_det
    # q = f × e1
    qx = fy * e1z - fz * e1y
    qy = fz * e1x - fx * e1z
    qz = fx * e1y - fy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (det != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
        & (t >= HIT_EPS)
    )
    return _closest(torch.where(valid, t, MISS))


def ray_aabb(
    origin: torch.Tensor,  # (..., 3)
    inv_direction: torch.Tensor,  # (..., 3)
    box_min: torch.Tensor,  # (..., 3)
    box_max: torch.Tensor,  # (..., 3)
    tmax: torch.Tensor,  # (...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branchless Tavian slab test (scene.cu:107-132): per-axis near / far
    planes folded into the window [0, tmax] with NaN-propagating
    ``torch.minimum`` / ``torch.maximum``, in the JAX operand order, the entry
    floored at 0. Returns (hit, tmin)."""
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    tmin = torch.zeros_like(tmax)
    for axis in range(3):
        a = t1[..., axis]
        b = t2[..., axis]
        tmin = torch.minimum(torch.maximum(a, tmin), torch.maximum(b, tmin))
        tmax = torch.maximum(torch.minimum(a, tmax), torch.minimum(b, tmax))
    return tmin <= tmax, tmin
