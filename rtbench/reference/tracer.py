"""Plain path tracer: the reference the benchmark holds the port's renders
and gradients against.

The upstream renderer's semantics (isaac-chandler/cuda-raytracer,
scene.cu:320-487 and raytracing.cu), ray for ray: pixel-major ray ids,
camera jitter and bounce draws from the PCG streams of ``pcg.py``, the
closest hit over spheres then triangles (Möller–Trumbore, hits at t >=
0.005, the lowest index wins a tie), an emissive add on hit, the rough
normal, the metallicity coin between specular and diffuse, Schlick and
total internal reflection for dielectrics, the nearest texel of the sky on
a miss. Passes of at most 20 rays a pixel are seeded with the samples left
after them. The float expressions follow the upstream order; sums over
three components run left to right.

The closest hit is a brute scan made affordable by boxes: triangles are
grouped 64 at a time in Morton order of their centroids, a ray tests every
group's padded box (a NaN counts as a hit, so the test only drops groups
the ray cannot reach), then every triangle of the groups it reaches. It
gives the exact closest hit whatever the grouping.

``dtype`` sets the float precision of everything but the draws' integer
streams: float32 is the reference, bfloat16 the lower-precision control.
Gradients reach the material table and the sky map through the
throughput's products (geometry detached, the metallicity coin as a
score-function term whose value is exactly 1), as the upstream estimator
for differentiable rendering defines them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from rtbench.reference import pcg
from rtbench.reference.dsl import SceneData

HIT_EPS = 0.005
MISS = 1e30
GROUP = 64
RAY_CHUNK = 8192  # rays per box test
PAIR_CHUNK = 65536  # (ray, group) pairs per triangle test
MAX_PER_PASS = 20
EPS_NORMALISE = 1e-20
ROT_A = float(np.float32(-0.386527))
ROT_B = float(np.float32(0.922278))
TWO_OVER_PI = float(np.float32(2.0 / np.pi))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalise_safe(a):
    return a / torch.clamp_min(torch.sqrt(dot(a, a)), EPS_NORMALISE)[..., None]


def _morton(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.where(hi > lo, hi - lo, 1.0) * 1023).astype(np.int64)
    code = np.zeros(len(points), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


@dataclasses.dataclass
class Geometry:
    """A scene's geometry on a device, in the tracer's precision."""

    p1: torch.Tensor  # (T + 1, 3): one degenerate triangle at the end pads the groups
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    group_tri: torch.Tensor  # (G, GROUP) int64 triangle rows
    group_min: torch.Tensor  # (G, 3) float32, padded
    group_max: torch.Tensor
    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor
    material_index: torch.Tensor  # (S + T,) int64: spheres first
    camera: Dict[str, torch.Tensor]
    width: int
    sphere_count: int
    triangle_count: int
    dtype: torch.dtype


def geometry(scene: SceneData, device, dtype=torch.float32) -> Geometry:
    """Upload ``scene``'s geometry and build the box groups."""
    T = len(scene.tri_p1)
    p2 = scene.tri_p1 + scene.tri_e1
    p3 = scene.tri_p1 + scene.tri_e2
    order = np.argsort(_morton((scene.tri_p1 + p2 + p3) / 3.0), kind="stable") if T else \
        np.zeros(0, np.int64)
    G = -(-T // GROUP)
    rows = np.full(G * GROUP, T, np.int64)
    rows[:T] = order
    rows = rows.reshape(G, GROUP)
    corners = np.stack([scene.tri_p1, p2, p3], axis=1)  # (T, 3, 3)
    corners = np.concatenate([corners, corners[:1] if T else np.zeros((1, 3, 3), np.float32)])
    gmin = corners[rows].min(axis=(1, 2))
    gmax = corners[rows].max(axis=(1, 2))
    pad = 1e-3 + 1e-5 * np.maximum(np.abs(gmin), np.abs(gmax))
    zero = np.zeros((1, 3), np.float32)

    def up(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return Geometry(
        p1=up(np.concatenate([scene.tri_p1, zero + 1e17])),
        e1=up(np.concatenate([scene.tri_e1, zero])),
        e2=up(np.concatenate([scene.tri_e2, zero])),
        normal=up(np.concatenate([scene.tri_normal, zero])),
        group_tri=up(rows, torch.int64),
        group_min=up(gmin - pad, torch.float32), group_max=up(gmax + pad, torch.float32),
        sphere_center=up(scene.sphere_center), sphere_radius=up(scene.sphere_radius),
        material_index=up(np.concatenate([scene.sphere_material, scene.tri_material]),
                          torch.int64),
        camera={k: up(np.asarray(v)) for k, v in scene.camera.items()},
        width=scene.width, sphere_count=len(scene.sphere_radius), triangle_count=T,
        dtype=dtype,
    )


def _spheres(geo: Geometry, o, d):
    S = geo.sphere_count
    R = o.shape[0]
    if S == 0:
        return (torch.full((R,), MISS, dtype=o.dtype, device=o.device),
                torch.full((R,), -1, dtype=torch.int64, device=o.device))
    c, r = geo.sphere_center, geo.sphere_radius
    ox, oy, oz = (c[None, :, i] - o[:, i:i + 1] for i in range(3))
    b = ox * d[:, 0:1] + oy * d[:, 1:2] + oz * d[:, 2:3]
    qc = ox * ox + oy * oy + oz * oz - r[None, :] * r[None, :]
    disc = b * b - qc
    h = torch.sqrt(torch.clamp_min(disc, 0.0))
    near, far = b - h, b + h
    t = torch.where(near >= HIT_EPS, near, torch.where(far >= HIT_EPS, far, MISS))
    t = torch.where(disc >= 0, t, MISS)
    best = t.amin(dim=1)
    cols = torch.arange(S, device=o.device)[None, :]
    idx = torch.where(t == best[:, None], cols, S).amin(dim=1)
    hit = best < MISS
    return torch.where(hit, best, MISS), torch.where(hit, idx, -1)


def _triangle_pairs(geo: Geometry, o, d, ray, grp):
    """Closest hit of each (ray, group) pair → (t, triangle row)."""
    tri = geo.group_tri[grp]  # (P, GROUP)
    ox, oy, oz = (o[ray, i:i + 1] for i in range(3))
    dx, dy, dz = (d[ray, i:i + 1] for i in range(3))
    p1x, p1y, p1z = (geo.p1[:, i][tri] for i in range(3))
    e1x, e1y, e1z = (geo.e1[:, i][tri] for i in range(3))
    e2x, e2y, e2z = (geo.e2[:, i][tri] for i in range(3))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = hx * e1x + hy * e1y + hz * e1z
    zero = det == 0
    inv_det = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, det))
    fx, fy, fz = ox - p1x, oy - p1y, oz - p1z
    u = (fx * hx + fy * hy + fz * hz) * inv_det
    qx = fy * e1z - fz * e1y
    qy = fz * e1x - fx * e1z
    qz = fx * e1y - fy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ~zero & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= HIT_EPS)
    t = torch.where(valid, t, MISS)
    best = t.amin(dim=1)
    row = torch.where(t == best[:, None], tri, geo.triangle_count + 1).amin(dim=1)
    return best, row


def _triangles(geo: Geometry, o, d):
    R = o.shape[0]
    best = torch.full((R,), MISS, dtype=o.dtype, device=o.device)
    row = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    if geo.triangle_count == 0:
        return best, row
    of, df = o.float(), d.float()
    inv = 1.0 / df
    for lo in range(0, R, RAY_CHUNK):
        ro, ri = of[lo:lo + RAY_CHUNK, None, :], inv[lo:lo + RAY_CHUNK, None, :]
        t1 = (geo.group_min[None] - ro) * ri
        t2 = (geo.group_max[None] - ro) * ri
        near = torch.minimum(t1, t2).amax(dim=2)
        far = torch.maximum(t1, t2).amin(dim=2)
        reach = ~(near > far) & ~(far < 0)
        ray, grp = reach.nonzero(as_tuple=True)
        ray = ray + lo
        ts, rows = [], []
        for p in range(0, ray.shape[0], PAIR_CHUNK):
            t, r = _triangle_pairs(geo, o, d, ray[p:p + PAIR_CHUNK], grp[p:p + PAIR_CHUNK])
            ts.append(t)
            rows.append(r)
        if not ts:
            continue
        t, r = torch.cat(ts), torch.cat(rows)
        best.scatter_reduce_(0, ray, t, reduce="amin")
        tie = torch.where(t == best[ray], r, geo.triangle_count + 1)
        first = torch.full((R,), geo.triangle_count + 1, dtype=torch.int64, device=o.device)
        first.scatter_reduce_(0, ray, tie, reduce="amin")
        row = torch.where(first <= geo.triangle_count, first, row)
    hit = best < MISS
    return best, torch.where(hit, row, -1)


def closest_hit(geo: Geometry, o, d):
    """(t, primitive) of the nearest hit: spheres [0, S), triangles after;
    (MISS, -1) on a miss."""
    t, prim = _spheres(geo, o, d)
    tt, row = _triangles(geo, o, d)
    better = tt < t
    return torch.where(better, tt, t), torch.where(better, geo.sphere_count + row, prim)


def sky(env: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The sky's nearest texel in ``direction`` (equal-area octahedral map,
    the upstream orientation); a 1×1 map is a constant sky."""
    H, W = env.shape[0], env.shape[1]
    if H * W == 1:
        return env.reshape(3).expand(direction.shape[:-1] + (3,))
    dx = direction[..., 0] * ROT_A + direction[..., 2] * ROT_B
    dy = direction[..., 0] * -ROT_B + direction[..., 2] * ROT_A
    dz = direction[..., 1]
    x, y, z = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    r = torch.sqrt(torch.clamp_min(1.0 - torch.clamp_max(z, 1.0), 0.0))
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    b = torch.where(a == 0, 0.0, b / torch.where(a == 0, 1.0, a))
    phi = TWO_OVER_PI * torch.atan(b)
    phi = torch.where(x < y, 1.0 - phi, phi)
    v = phi * r
    u = r - v
    south = dz < 0
    u, v = torch.where(south, 1.0 - v, u), torch.where(south, 1.0 - u, v)
    u = (torch.copysign(u, dx) + 1.0) * 0.5
    v = (torch.copysign(v, dy) + 1.0) * 0.5
    tx = torch.clamp((torch.clamp(u, 0.0, 1.0) * (W - 1) + 0.5).to(torch.int64), 0, W - 1)
    ty = torch.clamp((torch.clamp(v, 0.0, 1.0) * (H - 1) + 0.5).to(torch.int64), 0, H - 1)
    return env.reshape(-1, 3)[ty * W + tx]


def camera_rays(geo: Geometry, ray_id: torch.Tensor, rays_per_pixel: int, pass_seed: int):
    cam = geo.camera
    pixel = torch.div(ray_id, rays_per_pixel, rounding_mode="floor")
    px = torch.remainder(pixel, geo.width).to(geo.dtype)
    py = torch.div(pixel, geo.width, rounding_mode="floor").to(geo.dtype)
    jitter = pcg.camera_draws(ray_id, pass_seed)
    x = (px + pcg.to_01(jitter[0], geo.dtype)) * cam["inv_width"]
    y = (py + pcg.to_01(jitter[1], geo.dtype)) * cam["inv_height"]
    v = cam["top_left"][None, :] + x[:, None] * cam["scaled_right"][None, :] \
        - y[:, None] * cam["scaled_up"][None, :]
    direction = v / torch.sqrt(dot(v, v))[:, None]
    return cam["position"][None, :].expand(direction.shape), direction


def trace(geo: Geometry, mats: Dict[str, torch.Tensor], env: torch.Tensor,
          ray_id: torch.Tensor, rays_per_pixel: int, pass_seed: int, bounces: int):
    """Radiance collected by each ray of ``ray_id`` (int64), (R, 3).
    ``mats`` holds diffuse / specular / emit (M, 3) and metallicity /
    roughness / ior (M,); gradients reach them and ``env``."""
    dt = geo.dtype
    o, d = camera_rays(geo, ray_id, rays_per_pixel, pass_seed)
    R = ray_id.shape[0]
    thru = torch.ones((R, 3), dtype=dt, device=ray_id.device)
    coll = torch.zeros((R, 3), dtype=dt, device=ray_id.device)
    diffuse_t, specular_t, emit_t = (mats[k].to(dt) for k in ("diffuse", "specular", "emit"))
    metal_t, rough_t, ior_t = (mats[k].to(dt) for k in ("metallicity", "roughness", "ior"))
    env = env.to(dt)
    for bounce in range(bounces):
        alive = torch.any(thru != 0.0, dim=-1)
        with torch.no_grad():
            live = alive.nonzero(as_tuple=True)[0]
            t = torch.full((R,), -1.0, dtype=dt, device=o.device)
            prim = torch.full((R,), -1, dtype=torch.int64, device=o.device)
            if live.numel():
                tl, pl = closest_hit(geo, o[live], d[live])
                t[live], prim[live] = tl, pl
        miss = prim < 0
        t = torch.where(miss, 0.0, t)
        bits = pcg.bounce_draws(ray_id, pass_seed, bounce)
        sphere_a = pcg.on_sphere(bits[0], bits[1], dt)
        sphere_b = pcg.on_sphere(bits[3], bits[4], dt)
        branch_u = pcg.to_01(bits[2], dt)

        coll_miss = coll + sky(env, d) * thru
        hit_point = o + t[:, None] * d
        safe = torch.clamp(prim, 0, geo.material_index.shape[0] - 1)
        m = geo.material_index[safe]
        diffuse, specular, emitted = diffuse_t[m], specular_t[m], emit_t[m]
        metallicity, roughness, ior0 = metal_t[m], rough_t[m].detach(), ior_t[m].detach()
        is_sphere = prim < geo.sphere_count
        sph = torch.clamp(prim, 0, max(geo.sphere_count - 1, 0))
        tri = torch.clamp(prim - geo.sphere_count, 0, geo.normal.shape[0] - 1)
        if geo.sphere_count:
            radius = geo.sphere_radius[sph]
            sphere_n = (hit_point - geo.sphere_center[sph]) / \
                torch.where(radius == 0, 1.0, radius)[:, None]
            normal = torch.where(is_sphere[:, None], sphere_n, geo.normal[tri])
        else:
            normal = geo.normal[tri]
        front = dot(normal, d) < 0
        normal = torch.where(front[:, None], normal, -normal)
        rough_n = normalise_safe(normal + roughness[:, None] * sphere_a)
        cos_t = dot(rough_n, d)
        coll_hit = coll + emitted * thru

        spec_dir = d - 2.0 * cos_t[:, None] * rough_n
        diff_dir = normalise_safe(normal + sphere_b)
        take_spec = branch_u <= metallicity.detach()
        ior_nz = torch.where(ior0 == 0, 1.0, ior0)
        ior = torch.where(front, 1.0 / ior_nz, ior0)
        inv_ior = torch.where(front, ior0, 1.0 / ior_nz)
        sin2 = 1.0 - cos_t * cos_t
        r0 = (1.0 - ior) / (1.0 + ior)
        r0 = r0 * r0
        c = 1.0 + cos_t
        c2 = c * c
        reflectance = r0 + (1.0 - r0) * (c * (c2 * c2))
        take_reflect = (sin2 > inv_ior * inv_ior) | (branch_u < reflectance)
        perp = ior[:, None] * (d - cos_t[:, None] * rough_n)
        par_sq = 1.0 - dot(perp, perp)
        par = -torch.where(par_sq > 0, torch.sqrt(torch.where(par_sq > 0, par_sq, 1.0)),
                           0.0)[:, None] * rough_n
        refr_dir = normalise_safe(par + perp)
        dielectric = ior0 > 0
        spec_like = torch.where(dielectric, take_reflect, take_spec)
        tint = torch.where(spec_like[:, None], specular, diffuse)
        new_dir = torch.where(spec_like[:, None], spec_dir,
                              torch.where(dielectric[:, None], refr_dir, diff_dir))
        p_taken = torch.where(take_spec, metallicity, 1.0 - metallicity)
        p_safe = torch.clamp_min(torch.where(dielectric, 1.0, p_taken), 1e-6)
        thru_hit = thru * tint * (p_safe / p_safe.detach())[:, None]

        hit_upd = (alive & ~miss)[:, None]
        upd, miss2 = alive[:, None], miss[:, None]
        o = torch.where(hit_upd, hit_point, o).detach()
        d = torch.where(hit_upd, new_dir, d).detach()
        thru = torch.where(upd, torch.where(miss2, 0.0, thru_hit), thru)
        coll = torch.where(upd, torch.where(miss2, coll_miss, coll_hit), coll)
    return coll


def pixel_sums(geo: Geometry, mats, env, pixels: torch.Tensor, rays_per_pixel: int,
               bounces: int, max_per_pass: int = MAX_PER_PASS,
               block_pixels: Optional[int] = None) -> torch.Tensor:
    """Raw radiance sums of ``pixels`` (int64) over ``rays_per_pixel``
    samples, traced in passes of at most ``max_per_pass`` rays a pixel,
    each pass seeded with the samples left after it: (P, 3) float32."""
    out = torch.zeros((pixels.shape[0], 3), dtype=geo.dtype, device=pixels.device)
    block_pixels = block_pixels or pixels.shape[0]
    remaining = rays_per_pixel
    while remaining:
        chunk = min(remaining, max_per_pass)
        remaining -= chunk
        parts = []
        for lo in range(0, pixels.shape[0], block_pixels):
            px = pixels[lo:lo + block_pixels]
            ray_id = (px[:, None] * chunk + torch.arange(chunk, device=px.device)).reshape(-1)
            rad = trace(geo, mats, env, ray_id, chunk, remaining, bounces)
            parts.append(rad.reshape(px.shape[0], chunk, 3).sum(dim=1))
        out = out + torch.cat(parts)
    return out.float()


def material_tensors(scene: SceneData, device, requires_grad: bool = False):
    return {k: torch.tensor(v, device=device).requires_grad_(requires_grad)
            for k, v in scene.materials.items()}
