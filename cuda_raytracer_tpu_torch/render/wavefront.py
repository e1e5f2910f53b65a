"""Wavefront path tracing, brute-scene subset (counterpart of ``cuda_raytracer_tpu/render/wavefront.py``).

The whole wavefront is SoA ray state marched bounce by bounce: each bounce
finds the closest hit of every ray, then shades it (scene.cu:320-487
semantics: emissive add on hit, rough-normal perturbation,
metallicity-probability specular/diffuse split for opaque materials, Schlick
+ total-internal-reflection roulette for dielectrics). Draws come from the
counter-based PCG stream seeded per (stable ray id, bounce), so results do
not depend on execution order.

This is the port's plain PyTorch path: it renders brute scenes on any
device, and it is the plain version that the CUDA shade kernel
(``ops/kernels/shade.py``) is held against. The mesh path (packet and BVH
intersectors), the Morton reorder with live-prefix compaction and
reparameterised (differentiable) shading belong to later slices; asking for
them raises ``NotImplementedError`` rather than falling back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene
from cuda_raytracer_tpu_torch.ops import camera as camera_ops
from cuda_raytracer_tpu_torch.ops import envmap, intersect, rng, vecmath

# Per-(ray, bounce) seeding constants (raytracing.cu:89). The scalar seed is
# `pass_seed * 20 + bounce`.
BOUNCE_RAY_MULT = 4137874753
BOUNCE_SEED_MULT = 279220567
PASS_STRIDE = 20

_LATER = "is not ported yet (see ROADMAP.md queue A)"


class RayState(NamedTuple):
    """SoA wavefront state plus the stable ray id that carries pixel
    identity."""

    origin: torch.Tensor  # (R, 3)
    direction: torch.Tensor  # (R, 3)
    transmitted: torch.Tensor  # (R, 3)
    collected: torch.Tensor  # (R, 3)
    ray_id: torch.Tensor  # (R,) int32


def bounce_seeds(ray_id: torch.Tensor, pass_seed, bounce: int) -> torch.Tensor:
    """Per-ray 32-bit seeds of one bounce (int64 holding uint32 values):
    ``ray_id * 4137874753 + 279220567 * (pass_seed * 20 + bounce)`` mod 2^32."""
    scalar = ((int(pass_seed) & rng.MASK32) * PASS_STRIDE + bounce) & rng.MASK32
    term = (BOUNCE_SEED_MULT * scalar) & rng.MASK32
    return (rng.mul32(rng.as_u32(ray_id), BOUNCE_RAY_MULT) + term) & rng.MASK32


def resolved_intersector(scene: Scene) -> str:
    """The triangle intersector closest_hit would use: auto → brute up to
    512 triangles, packet above; a single-leaf tree or no triangles →
    brute."""
    mode = scene.config.intersector
    if mode not in ("auto", "brute", "packet", "bvh"):
        raise ValueError(
            f"unknown intersector {mode!r}; expected auto | brute | packet | bvh"
        )
    if mode == "auto":
        mode = "brute" if scene.triangle_count <= 512 else "packet"
    if scene.bvh_node_count <= 1 or scene.triangle_count == 0:
        mode = "brute"
    return mode


def reorder_is_useful(scene: Scene) -> bool:
    """Morton reordering pays only for the packet / BVH intersectors."""
    return resolved_intersector(scene) != "brute"


def wavefront_ordered(scene: Scene, sort_rays: bool, bounces: int) -> bool:
    """True when trace_wavefront never reorders the rays."""
    return not (
        sort_rays
        and reorder_is_useful(scene)
        and bounces > 1
        and (scene.config.sort_depth or bounces) > 0
    )


def closest_hit(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    alive: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Nearest hit over spheres then triangles (brute (rays x tris) tile).
    Dead rays get ``t = -1`` so no triangle can beat it.

    Returns (t, index, suspect); ``suspect`` counts rays whose result could
    not be certified exact, and is always 0 on the brute path."""
    t, index = intersect.intersect_spheres(
        origin, direction, scene.sphere_center, scene.sphere_radius
    )
    if alive is not None:
        t = torch.where(alive, t, -1.0)
    if scene.triangle_count == 0:
        return t, index, 0
    mode = resolved_intersector(scene)
    if mode != "brute":
        raise NotImplementedError(f"the {mode!r} intersector {_LATER}")
    t_tri, i_tri = intersect.intersect_triangles_brute(
        origin, direction, scene.tri_p1, scene.tri_e1, scene.tri_e2
    )
    better = t_tri < t
    t = torch.where(better, t_tri, t)
    index = torch.where(better, scene.sphere_count + i_tri, index)
    return t, index, 0


def _gather_normal(
    scene: Scene, hit_index: torch.Tensor, hit_point: torch.Tensor
) -> torch.Tensor:
    """Surface normal for the shared sphere/triangle hit-index space. The
    sphere normal divides by the radius, ``(hp - c) / r``, exactly as the
    JAX wavefront path does."""
    is_sphere = hit_index < scene.sphere_count
    sphere_i = torch.clamp(hit_index, 0, scene.sphere_center.shape[0] - 1).long()
    tri_i = torch.clamp(
        hit_index - scene.sphere_count, 0, scene.tri_normal.shape[0] - 1
    ).long()
    center = scene.sphere_center[sphere_i]
    radius = scene.sphere_radius[sphere_i]
    sphere_n = (hit_point - center) / torch.where(radius == 0, 1.0, radius)[:, None]
    tri_n = scene.tri_normal[tri_i]
    return torch.where(is_sphere[:, None], sphere_n, tri_n)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 (0 where x <= 0)."""
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)


def pow5(x: torch.Tensor) -> torch.Tensor:
    """``x**5`` by square-and-multiply, ``x * ((x*x) * (x*x))``: the
    rounding JAX's integer power uses (``torch.pow`` rounds differently)."""
    x2 = x * x
    return x * (x2 * x2)


def process_rays(
    scene: Scene, state: RayState, pass_seed, bounce: int, reparam: bool = False
) -> Tuple[RayState, int]:
    """One bounce for the whole wavefront (reference Scene::process_ray,
    scene.cu:320-487). Returns (new_state, suspect)."""
    if reparam:
        raise NotImplementedError(f"reparameterised shading {_LATER}")
    alive = torch.any(state.transmitted != 0.0, dim=-1)

    t, hit_index, suspect = closest_hit(scene, state.origin, state.direction, alive)
    miss = hit_index < 0
    # Keep the 1e30 sentinel out of downstream products.
    t = torch.where(miss, 0.0, t)

    draws = rng.uniforms(bounce_seeds(state.ray_id, pass_seed, bounce), 5)
    sphere_a = rng.on_sphere_from_bits(draws[0], draws[1])  # rough normal
    sphere_b = rng.on_sphere_from_bits(draws[3], draws[4])  # diffuse dir
    branch_u = rng.to_01(draws[2])  # metallicity / roulette draw

    # ---- Miss: environment radiance, ray dies -----------------------------
    sky = envmap.sample_environment(scene.environment_map, state.direction)
    collected_miss = state.collected + sky * state.transmitted

    # ---- Hit: emissive add + scatter --------------------------------------
    hit_point = state.origin + t[:, None] * state.direction
    hit_safe = torch.clamp(hit_index, 0, scene.material_index.shape[0] - 1).long()
    mat_i = scene.material_index[hit_safe].long()
    mats = scene.materials
    diffuse = mats.diffuse_albedo[mat_i]
    specular = mats.specular_albedo[mat_i]
    emitted = mats.emitted[mat_i]
    metallicity = mats.metallicity[mat_i]
    roughness = mats.roughness[mat_i]
    ior0 = mats.index_of_refraction[mat_i]

    normal = _gather_normal(scene, hit_safe, hit_point)
    front_face = vecmath.dot(normal, state.direction) < 0
    normal = torch.where(front_face[:, None], normal, -normal)

    rough_normal = vecmath.normalise_safe(normal + roughness[:, None] * sphere_a)
    cos_theta = vecmath.dot(rough_normal, state.direction)

    collected_hit = state.collected + emitted * state.transmitted

    # Opaque branch (ior == 0): metallicity coin flip.
    specular_dir = state.direction - 2.0 * cos_theta[:, None] * rough_normal
    diffuse_dir = vecmath.normalise_safe(normal + sphere_b)
    take_specular = branch_u <= metallicity

    # Dielectric branch: swap ior for front faces, Schlick reflectance,
    # TIR-or-roulette reflect, else Snell refraction.
    ior_nz = torch.where(ior0 == 0, 1.0, ior0)
    ior = torch.where(front_face, 1.0 / ior_nz, ior0)
    inv_ior = torch.where(front_face, ior0, 1.0 / ior_nz)
    sin_theta_sq = 1.0 - cos_theta * cos_theta
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    cosine = 1.0 + cos_theta
    reflectance = r0 + (1.0 - r0) * pow5(cosine)
    take_reflect = (sin_theta_sq > inv_ior * inv_ior) | (branch_u < reflectance)
    r_out_perp = ior[:, None] * (state.direction - cos_theta[:, None] * rough_normal)
    r_out_par = -_safe_sqrt(1.0 - vecmath.magnitude_squared(r_out_perp))[:, None] * rough_normal
    refract_dir = vecmath.normalise_safe(r_out_par + r_out_perp)

    is_dielectric = ior0 > 0
    spec_like = torch.where(is_dielectric, take_reflect, take_specular)
    tint = torch.where(spec_like[:, None], specular, diffuse)
    new_dir = torch.where(
        spec_like[:, None],
        specular_dir,
        torch.where(is_dielectric[:, None], refract_dir, diffuse_dir),
    )
    # The JAX path also multiplies by a score-function weight that is
    # exactly 1.0 in value (it only carries a gradient); forward values
    # are unchanged without it.
    transmitted_hit = state.transmitted * tint

    # ---- Merge miss/hit, mask dead rays -----------------------------------
    update = alive[:, None]
    hit_update = (alive & ~miss)[:, None]
    miss = miss[:, None]
    new_state = RayState(
        origin=torch.where(hit_update, hit_point, state.origin),
        direction=torch.where(hit_update, new_dir, state.direction),
        transmitted=torch.where(
            update, torch.where(miss, 0.0, transmitted_hit), state.transmitted
        ),
        collected=torch.where(
            update, torch.where(miss, collected_miss, collected_hit), state.collected
        ),
        ray_id=state.ray_id,
    )
    return new_state, suspect


def make_initial_state(
    scene: Scene, ray_id: torch.Tensor, rays_per_pixel: int, pass_seed
) -> RayState:
    origin, direction = camera_ops.generate_rays(
        scene.camera, scene.config.width, rays_per_pixel, ray_id, pass_seed
    )
    rays = ray_id.shape[0]
    return RayState(
        origin=origin,
        direction=direction,
        transmitted=torch.ones((rays, 3), dtype=torch.float32, device=ray_id.device),
        collected=torch.zeros((rays, 3), dtype=torch.float32, device=ray_id.device),
        ray_id=ray_id.to(torch.int32),
    )


def trace_wavefront(
    scene: Scene,
    state: RayState,
    pass_seed,
    bounces: int,
    sort_rays: bool,
    reparam: bool = False,
) -> Tuple[RayState, int]:
    """March the wavefront through ``bounces`` scatter events, in ray order.
    Returns (state, suspect), ``suspect`` summed over bounces."""
    if sort_rays and reorder_is_useful(scene):
        raise NotImplementedError(f"the Morton ray reorder {_LATER}")
    suspect_total = 0
    for bounce in range(bounces):
        state, suspect = process_rays(scene, state, pass_seed, bounce, reparam=reparam)
        suspect_total += suspect
    return state, suspect_total


def accumulate_radiance(
    state: RayState,
    rays_per_pixel: int,
    num_pixels: int,
    ordered: bool = False,
) -> torch.Tensor:
    """Per-pixel radiance sums of a wavefront in ray-id order (rays are
    pixel-major, so this is a reshape-sum)."""
    if not ordered:
        raise NotImplementedError(f"the by-ray-id unsort of a reordered wavefront {_LATER}")
    return state.collected.reshape(num_pixels, rays_per_pixel, 3).sum(dim=1)
