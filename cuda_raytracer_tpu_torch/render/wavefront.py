"""Wavefront path tracing (counterpart of ``cuda_raytracer_tpu/render/wavefront.py``).

The whole wavefront is SoA ray state marched bounce by bounce: each bounce
finds the closest hit of every ray, then shades it (scene.cu:320-487
semantics: emissive add on hit, rough-normal perturbation,
metallicity-probability specular/diffuse split for opaque materials, Schlick
+ total-internal-reflection roulette for dielectrics). Draws come from the
counter-based PCG stream seeded per (stable ray id, bounce), so results do
not depend on execution order.

This is the port's PyTorch wavefront: it renders brute scenes on any
device (and is the plain version the CUDA shade kernel,
``ops/kernels/shade.py``, is held against), and mesh scenes through the
intersector ``resolved_intersector`` picks: on a CUDA device "auto" walks
the BVH, elsewhere it takes the packet intersector
(``ops/packet_intersect.py``), whose kernels run on a CUDA device when it
is asked for by name. A forward trace (no autograd graph to build) runs on
packed rows (``render/packed.py``), bounce by bounce through ``packed_bounce``:
the set-up, closest-hit and bounce kernels (``ops/kernels/rays.py``,
``ops/kernels/bounce.py``) on a CUDA device, their plain versions (this
module's torch shading) on the CPU. A trace that builds a graph shades with
torch (``trace_rays``); both follow one ``bounce_schedule``. The BVH
walk (``intersector="bvh"``, or "auto" on the card) is
``ops/kernels/traverse.bvh_walk``: one thread per ray in
``csrc/traverse.cu`` on the card, ``ops/traverse.py``'s lockstep walk on the
CPU. Where that pays (``reorder_is_useful``: the packet intersector, and
the walk off the card) the wavefront is reordered between bounces by
Morton key, or for a packet scene by ``sort_key="cullhit"``'s
first two slab-hit cluster ids (chunk-local, see ``SORT_CHUNK``), and each
bounce runs on the smallest static prefix that holds every live ray
(dead-ray compaction); a final by-ray-id unsort restores pixel order.

Differentiation (``render/diff.py``): radiance is ``collected += emitted ⊙
transmitted`` with ``transmitted`` a product of gathered albedos, so
gradients reach the material colours and the sky map. Each bounce is split
in two: the hit record (closest hit, material id and, in detached mode, the
geometric normal) is computed without gradient on detached rays, and the
shading takes it as an input. By default geometry is detached at every
point the JAX package stops gradients; with ``reparam=True`` the hit
distance is re-derived smoothly for the chosen primitive and directions stay
in the graph (pathwise gradients for roughness and ior, bilinear sky). The
metallicity coin adds a score-function term whose weight is exactly 1.0 in
value. With ``checkpoint_bounces`` only the shading is recomputed in the
backward pass (``torch.utils.checkpoint``): the closest hit and the Morton
permutation are computed once, in the forward pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from cuda_raytracer_tpu_torch.models.scene import Scene
from cuda_raytracer_tpu_torch.ops import camera as camera_ops
from cuda_raytracer_tpu_torch.ops import envmap, intersect, packet_intersect, rng, vecmath
from cuda_raytracer_tpu_torch.ops.kernels import bounce as bounce_kernel
from cuda_raytracer_tpu_torch.ops.kernels import rays as rays_kernel
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.utils import metrics as recording

# Bounces whose closest hit uses the "pallas" engine's two-round sweep (the
# wavefront is still large there but has lost primary-ray coherence).
TWO_ROUND_BOUNCES = (1, 2)


class RayState(NamedTuple):
    """SoA wavefront state plus the stable ray id that carries pixel
    identity."""

    origin: torch.Tensor  # (R, 3)
    direction: torch.Tensor  # (R, 3)
    transmitted: torch.Tensor  # (R, 3)
    collected: torch.Tensor  # (R, 3)
    ray_id: torch.Tensor  # (R,) int32


def wavefront_ordered(scene: Scene, rays: int, bounces: int, sort_rays: bool) -> bool:
    """True when a trace of ``rays`` rows never reorders them (``bounce_schedule``)."""
    return not any(bounce_schedule(scene, rays, bounces, sort_rays).sorted)


def closest_hit(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    alive: torch.Tensor = None,
    two_round: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Nearest hit over spheres, then triangles: a brute (rays x tris) tile
    for small scenes, the packet intersector above 512 triangles. Dead rays
    enter with a negative window (``t = -1``), so nothing can beat it.
    ``two_round`` asks the ``"pallas"`` packet engine for its front-to-back
    two-round sweep (other engines ignore it).

    Returns (t, index, suspect); ``suspect`` counts rays whose result could
    not be certified exact (the packet engines' pair budgets); 0 means
    exact, and render_framebuffer retries or raises on nonzero."""
    t, index = intersect.intersect_spheres(
        origin, direction, scene.sphere_center, scene.sphere_radius
    )
    if alive is not None:
        t = torch.where(alive, t, -1.0)
    return triangle_hit(scene, origin, direction, t, index, two_round)


def triangle_hit(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                 t: torch.Tensor, index: torch.Tensor, two_round: bool = False):
    """``closest_hit`` after the spheres: (t, index), the sphere hit (t = -1
    on a dead ray), updated with the nearest triangle → (t, index, suspect).
    While recording, its rows count as ``hit.rows``, and as ``hit.walk_rows``
    too where the BVH walk takes them."""
    if scene.triangle_count == 0:
        return t, index, 0
    mode = resolved_intersector(scene)
    recording.count("hit.rows", origin.shape[0])
    if mode == "packet":
        cfg = scene.config
        return packet_intersect.closest_hit_packet(
            scene, origin, direction, t, index,
            tile=cfg.packet_tile,
            cap=min(cfg.packet_cap, scene.num_clusters),
            backend=cfg.packet_backend,
            two_round=two_round and cfg.packet_backend == "pallas",
            skip=cfg.packet_skip,
        )
    if mode == "bvh":
        recording.count("hit.walk_rows", origin.shape[0])
        t, index = traverse_kernel.bvh_walk(scene, origin, direction, t, index)
        return t, index, 0
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


def recompute_hit_distance(
    scene: Scene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    hit_index: torch.Tensor,
    t_detached: torch.Tensor,
) -> torch.Tensor:
    """Differentiable hit distance for an already chosen primitive.

    The closest-hit search is a discrete choice, so reparameterised mode
    detaches the choice of primitive and re-evaluates the analytic distance
    of that primitive only (the sphere quadratic, the root nearer the
    detached t, or Möller–Trumbore), which is smooth in origin and
    direction. Miss lanes return 0, so no 1e30 sentinel enters the graph."""
    hit_index = hit_index.detach()
    t_detached = t_detached.detach()
    is_sphere = (hit_index >= 0) & (hit_index < scene.sphere_count)
    is_tri = hit_index >= scene.sphere_count

    sphere_i = torch.clamp(hit_index, 0, scene.sphere_center.shape[0] - 1).long()
    center = scene.sphere_center[sphere_i]
    radius = scene.sphere_radius[sphere_i]
    offset = center - origin
    minus_half_b = vecmath.dot(offset, direction)
    quarter_disc = (minus_half_b * minus_half_b - vecmath.magnitude_squared(offset)
                    + radius * radius)
    half_sqrt = _safe_sqrt(quarter_disc)
    near = minus_half_b - half_sqrt
    far = minus_half_b + half_sqrt
    take_near = torch.abs(near - t_detached) <= torch.abs(far - t_detached)
    t_sphere = torch.where(take_near, near, far)

    tri_i = torch.clamp(hit_index - scene.sphere_count, 0, scene.tri_p1.shape[0] - 1).long()
    p1 = scene.tri_p1[tri_i]
    e1 = scene.tri_e1[tri_i]
    e2 = scene.tri_e2[tri_i]
    h = vecmath.cross(direction, e2)
    det = vecmath.dot(h, e1)
    inv_det = torch.where(det == 0, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
    q = vecmath.cross(origin - p1, e1)
    t_tri = vecmath.dot(e2, q) * inv_det

    return torch.where(is_sphere, t_sphere, torch.where(is_tri, t_tri, 0.0))


class HitRecord(NamedTuple):
    """What a bounce's shading needs from the closest-hit search, computed
    without gradient (JAX saves the same tensors across its per-bounce
    checkpoint: ``hit_t``, ``hit_index``, ``hit_mat``, ``hit_geom_normal``)."""

    alive: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) closest-hit distance (1e30 on misses, -1 for dead rays)
    hit_index: torch.Tensor  # (R,) int32, -1 on misses
    mat_i: torch.Tensor  # (R,) int64 material row
    normal: Optional[torch.Tensor]  # (R, 3) geometric normal; None in reparam mode


def closest_hit_of(scene: Scene, state: RayState, bounce: int):
    """The closest hit of every ray of ``state`` on detached rays, under
    ``torch.no_grad()`` → (alive, t, hit_index, suspect). The ``"pallas"``
    engine runs its two-round sweep on the bounces of ``TWO_ROUND_BOUNCES``."""
    with torch.no_grad():
        alive = torch.any(state.transmitted != 0.0, dim=-1)
        t, hit_index, suspect = closest_hit(scene, state.origin.detach(),
                                            state.direction.detach(), alive,
                                            two_round=bounce in TWO_ROUND_BOUNCES)
    return alive, t, hit_index, suspect


def gather_hit(scene: Scene, state: RayState, alive: torch.Tensor, t: torch.Tensor,
               hit_index: torch.Tensor, reparam: bool = False) -> HitRecord:
    """The hit record of a closest hit: material row and, in detached mode,
    the geometric normal, gathered without gradient."""
    with torch.no_grad():
        hit_safe = torch.clamp(hit_index, 0, scene.material_index.shape[0] - 1).long()
        mat_i = scene.material_index[hit_safe].long()
        normal = None
        if not reparam:
            # Geometry carries no gradient in detached mode: the normal of
            # the hit is part of the record, outside the recomputed shading.
            origin, direction = state.origin.detach(), state.direction.detach()
            hit_point = origin + torch.where(hit_index < 0, 0.0, t)[:, None] * direction
            normal = _gather_normal(scene, hit_safe, hit_point)
    return HitRecord(alive, t, hit_index, mat_i, normal)


def material_rows(mats, mat_i: torch.Tensor, sampling_grad: bool = True) -> torch.Tensor:
    """Each ray's material row, (R, 12) float32 [diffuse specular emitted
    metallicity roughness ior], as the JAX package looks it up: a one-hot
    (R, M) matrix times the (M, 12) table, so the backward pass is a matmul
    into the table and not the row gather's scatter-add. With
    ``sampling_grad`` False (detached mode) roughness and ior enter the
    table detached, so no graph edge reaches them.

    With 0/1 rows the product reproduces the table entries exactly, the
    gather's bits. It is computed in float64, where TF32 cannot reach
    (``torch.backends.cuda.matmul.allow_tf32`` rounds float32 products
    only), so no global setting can change it."""
    roughness, ior = mats.roughness, mats.index_of_refraction
    if not sampling_grad:
        roughness, ior = roughness.detach(), ior.detach()
    table = torch.cat([mats.diffuse_albedo, mats.specular_albedo, mats.emitted,
                       mats.metallicity[:, None], roughness[:, None], ior[:, None]], dim=1)
    ids = torch.arange(table.shape[0], dtype=mat_i.dtype, device=mat_i.device)
    onehot = (mat_i[:, None] == ids).to(torch.float64)
    return torch.matmul(onehot, table.to(torch.float64)).to(torch.float32)


def shade(
    scene: Scene, state: RayState, hit: HitRecord, pass_seed, bounce: int,
    reparam: bool = False, plain_draws: bool = False,
) -> RayState:
    """One bounce's shading given its hit record (reference
    Scene::process_ray, scene.cu:320-487): the differentiable part of
    ``process_rays``. Its PCG draws come from ``rays.bounce_draws`` (one
    kernel on the card, the same bits as the torch PCG), or with
    ``plain_draws`` from the torch PCG on any device."""
    alive, hit_index = hit.alive, hit.hit_index
    miss = hit_index < 0
    if reparam:
        t = recompute_hit_distance(scene, state.origin, state.direction, hit_index, hit.t)
    else:
        # Keep the 1e30 sentinel out of downstream products.
        t = torch.where(miss, 0.0, hit.t)

    if plain_draws:
        draws = rays_kernel.plain_bounce_draws(state.ray_id, pass_seed, bounce)
    else:
        draws = rays_kernel.bounce_draws(state.ray_id.contiguous(), pass_seed, bounce)
    sphere_a = rng.on_sphere_from_bits(draws[0], draws[1])  # rough normal
    sphere_b = rng.on_sphere_from_bits(draws[3], draws[4])  # diffuse dir
    branch_u = rng.to_01(draws[2])  # metallicity / roulette draw

    # ---- Miss: environment radiance, ray dies -----------------------------
    # Reparameterised mode filters bilinearly, so the sky is smooth in the
    # traced scatter direction; otherwise the reference's nearest fetch.
    sky = envmap.sample_environment(scene.environment_map, state.direction,
                                    bilinear=reparam)
    collected_miss = state.collected + sky * state.transmitted

    # ---- Hit: emissive add + scatter --------------------------------------
    hit_point = state.origin + t[:, None] * state.direction
    # Detached sampling: geometry, roughness and ior carry no gradient.
    rows = material_rows(scene.materials, hit.mat_i, sampling_grad=reparam)
    diffuse, specular, emitted = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    metallicity, roughness, ior0 = rows[:, 9], rows[:, 10], rows[:, 11]

    if reparam:
        hit_safe = torch.clamp(hit_index, 0, scene.material_index.shape[0] - 1).long()
        normal = _gather_normal(scene, hit_safe, hit_point)
    else:
        normal = hit.normal
    front_face = vecmath.dot(normal, state.direction) < 0
    normal = torch.where(front_face[:, None], normal, -normal)

    rough_normal = vecmath.normalise_safe(normal + roughness[:, None] * sphere_a)
    cos_theta = vecmath.dot(rough_normal, state.direction)

    collected_hit = state.collected + emitted * state.transmitted

    # Opaque branch (ior == 0): metallicity coin flip.
    specular_dir = state.direction - 2.0 * cos_theta[:, None] * rough_normal
    diffuse_dir = vecmath.normalise_safe(normal + sphere_b)
    take_specular = branch_u <= metallicity.detach()

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
    take_reflect = (sin_theta_sq > inv_ior * inv_ior) | (branch_u < reflectance.detach())
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
    # Score-function gradient of the opaque metallicity coin: the continuing
    # throughput is scaled by P(branch) / detached P(branch), exactly 1.0 in
    # value (x / x), so forward renders keep their bits while the backward
    # pass gets d log P(branch) / d metallicity.
    p_taken = torch.where(take_specular, metallicity, 1.0 - metallicity)
    p_safe = torch.clamp_min(torch.where(is_dielectric, 1.0, p_taken), 1e-6)
    score_w = p_safe / p_safe.detach()
    transmitted_hit = state.transmitted * tint * score_w[:, None]

    # ---- Merge miss/hit, mask dead rays -----------------------------------
    update = alive[:, None]
    hit_update = (alive & ~miss)[:, None]
    miss = miss[:, None]
    new_origin = torch.where(hit_update, hit_point, state.origin)
    new_direction = torch.where(hit_update, new_dir, state.direction)
    if not reparam:
        new_origin, new_direction = new_origin.detach(), new_direction.detach()
    return RayState(
        origin=new_origin,
        direction=new_direction,
        transmitted=torch.where(
            update, torch.where(miss, 0.0, transmitted_hit), state.transmitted
        ),
        collected=torch.where(
            update, torch.where(miss, collected_miss, collected_hit), state.collected
        ),
        ray_id=state.ray_id,
    )


def _needs_graph(scene: Scene, state: RayState = None) -> bool:
    """True when shading this state builds an autograd graph. Without a
    state, for the fresh camera rays of a trace yet to start: they require
    grad only where a camera tensor does."""
    leaves = (state[:4] if state is not None else
              [getattr(scene.camera, f.name) for f in dataclasses.fields(scene.camera)
               if isinstance(getattr(scene.camera, f.name), torch.Tensor)])
    return torch.is_grad_enabled() and (
        any(leaf.requires_grad for leaf in leaves)
        or scene.environment_map.requires_grad
        or any(getattr(scene.materials, f.name).requires_grad
               for f in dataclasses.fields(scene.materials))
    )


def process_rays(
    scene: Scene, state: RayState, pass_seed, bounce: int, reparam: bool = False,
    checkpoint: bool = False,
) -> Tuple[RayState, int]:
    """One bounce for the whole wavefront (reference Scene::process_ray,
    scene.cu:320-487): ``closest_hit_of`` and ``gather_hit``, then ``shade``,
    the torch shading. Returns (new_state, suspect). With ``checkpoint`` and a graph to build,
    the shading runs under ``torch.utils.checkpoint``: the backward pass
    recomputes it from the state and the hit record and never repeats the
    closest-hit search."""
    alive, t, hit_index, suspect = closest_hit_of(scene, state, bounce)
    hit = gather_hit(scene, state, alive, t, hit_index, reparam)
    if checkpoint and _needs_graph(scene, state):
        new_state = torch.utils.checkpoint.checkpoint(
            shade, scene, state, hit, pass_seed, bounce, reparam,
            use_reentrant=False, preserve_rng_state=False,
        )
    else:
        new_state = shade(scene, state, hit, pass_seed, bounce, reparam)
    return new_state, suspect


def make_initial_state(
    scene: Scene, ray_id: torch.Tensor, rays_per_pixel: int, pass_seed, plain: bool = False
) -> RayState:
    """The camera rays of ``ray_id`` at full throughput; with ``plain`` the
    camera's draws come from the torch PCG on any device."""
    return initial_state(scene.camera, scene.config.width, ray_id, rays_per_pixel, pass_seed,
                         plain=plain)


def initial_state(camera, width: int, ray_id: torch.Tensor, rays_per_pixel: int, pass_seed,
                  plain: bool = False) -> RayState:
    """``make_initial_state`` of a camera (anything with the fields
    ``camera.generate_rays`` reads) and an image width."""
    origin, direction = camera_ops.generate_rays(
        camera, width, rays_per_pixel, ray_id, pass_seed, plain=plain
    )
    rays = ray_id.shape[0]
    return RayState(
        origin=origin,
        direction=direction,
        transmitted=torch.ones((rays, 3), dtype=torch.float32, device=ray_id.device),
        collected=torch.zeros((rays, 3), dtype=torch.float32, device=ray_id.device),
        ray_id=ray_id.to(torch.int32),
    )


# Rays per closest hit and shading (process_rays_tiled, packed_bounce): bounds
# the per-call working set (intersection tiles, cull matrices) whatever the
# wavefront size.
ROW_TILE = 1 << 18


def process_rays_tiled(
    scene: Scene,
    state: RayState,
    pass_seed,
    bounce: int,
    reparam: bool = False,
    checkpoint: bool = False,
) -> Tuple[RayState, int]:
    """process_rays over ROW_TILE-ray tiles. Within a bounce every ray is
    independent, so cutting the wavefront and concatenating is exact."""
    rays = state.origin.shape[0]
    if rays <= ROW_TILE:
        return process_rays(scene, state, pass_seed, bounce, reparam=reparam,
                            checkpoint=checkpoint)
    parts, suspect = [], 0
    for lo in range(0, rays, ROW_TILE):
        part, s = process_rays(
            scene, RayState(*(leaf[lo:lo + ROW_TILE] for leaf in state)),
            pass_seed, bounce, reparam=reparam, checkpoint=checkpoint,
        )
        parts.append(part)
        suspect = suspect + s
    return RayState(*(torch.cat(leaves) for leaves in zip(*parts))), suspect


# Static prefix sizes for live-prefix processing (dead-ray compaction), as
# divisors of the wavefront. After a Morton sort of the whole wavefront,
# dead rays (key 0xFFFFFFFF) sit at the tail, so a bounce only needs the
# smallest static prefix covering the live bound.
LIVE_PREFIX_DIVISORS = (1, 4, 16, 64)


def prefix_quantum(scene: Scene, rays: int) -> int:
    """Prefix granularity: whole intersection tiles when the Morton sort is
    global; whole sort chunks otherwise (a prefix sort must keep the chunk
    boundaries of the full-wavefront sort, or the chunk-local unsort would
    break)."""
    cs = sort_chunk_size(rays)
    return scene.config.packet_tile if cs == rays else cs


def prefix_for_divisor(scene: Scene, rays: int, divisor) -> int:
    """ceil(rays / divisor) rounded up to the prefix quantum; ``divisor``
    may be fractional."""
    quantum = prefix_quantum(scene, rays)
    n = int(-(-rays // max(1, divisor)))
    return min(rays, -(-n // quantum) * quantum)


def live_prefix_sizes(scene: Scene, rays: int) -> list:
    """Static prefix sizes (descending) for dead-ray compaction."""
    sizes = []
    for div in LIVE_PREFIX_DIVISORS:
        n = prefix_for_divisor(scene, rays, div)
        if n not in sizes:
            sizes.append(n)
    return sizes


# "auto" keeps scenes of at most this many triangles on the brute tile.
BRUTE_MAX_TRIANGLES = 512


def resolve_intersector(mode: str, triangle_count: int, bvh_node_count: int,
                        device_type: str) -> str:
    """The triangle intersector of a scene: ``"auto"`` becomes brute up to
    BRUTE_MAX_TRIANGLES triangles; above, the BVH walk on a CUDA device and
    the packet intersector elsewhere. A single-leaf tree or no triangles →
    brute, whatever the mode; an explicit mode is otherwise returned as it
    is. Off the card "auto" is the JAX package's rule (measured on a TPU
    v5e), so the CPU tests hold the port to JAX like for like. On an H100
    (NVIDIA H100 80GB HBM3, 700 W; turns bvh, packet, packet, bvh) at
    1000×1000 × 10 bounces the walk won every turn at 126,000 triangles and
    above: at 100 rays a pixel the torus in 1.63–1.71 s against 4.97–5.06
    s, its glass form 1.55–1.76 against 4.63–4.74, the torus without its
    ground 1.51–1.64 against 2.40–2.50, the 619,502-triangle one 1.62–1.78
    against 15.9–16.3; at 1 ray a pixel 0.017–0.026 s against 0.050–0.190
    s. Smaller tori: at 514 and 770 triangles the two tie at 100 rays a
    pixel (1.27–1.58 s against 1.43–1.55) and the walk wins at 1 (0.016–
    0.020 s against 0.029–0.037); at 2,402, 9,602 and 36,002 it wins at
    both (at 100: 1.31–1.63 s against 1.88–3.41). BRUTE_MAX_TRIANGLES is the JAX
    package's cut-off; on the card it was timed against the walk only at 450
    triangles under a sky map (no megakernel: the wavefront's brute path),
    where brute took 87.8 s and the walk 1.58 (PERF.md §7). A brute scene
    traces through the shade megakernel on the card where its tables hold it
    (``shade.megakernel_eligible``: at most 32 spheres, 128 triangles and 16
    materials, a constant sky); any other, such as a sphere scene beyond
    those tables or under a sky map, runs the wavefront's brute path, whose
    closest hit is the set-up kernel's loop over every sphere row
    (``rays.rays_setup``) and, with triangles, the brute tile here."""
    if mode not in ("auto", "brute", "packet", "bvh"):
        raise ValueError(
            f"unknown intersector {mode!r}; expected auto | brute | packet | bvh"
        )
    if bvh_node_count <= 1 or triangle_count == 0 or (
            mode == "auto" and triangle_count <= BRUTE_MAX_TRIANGLES):
        return "brute"
    if mode == "auto":
        return "bvh" if device_type == "cuda" else "packet"
    return mode


def resolved_intersector(scene: Scene) -> str:
    """The triangle intersector closest_hit uses (``resolve_intersector`` on
    the scene's device)."""
    return resolve_intersector(scene.config.intersector, scene.triangle_count,
                               scene.bvh_node_count, scene.device.type)


def reorder_is_useful(scene: Scene) -> bool:
    """Morton reordering pays only through tile coherence in the packet
    intersector; for brute scenes it is pure cost, and so it is for the BVH
    walk on a CUDA device, one thread a ray with no tiles. On an H100
    (NVIDIA H100 80GB HBM3, 700 W; 1000×1000 × 100 spp × 10 bounces, sorted
    and unsorted in turns) the walk's images took 0.536 s unsorted against
    0.714 sorted on the 126,000-triangle torus, 0.618 against 0.777 on its
    glass form and 1.027 against 1.303 on the 619,350-triangle desk lamp,
    the framebuffers bit-identical: the key, the sort, the row move and the
    live-count reads cost more than the walk loses on rows in launch order
    with the dead ones left in (14–17 % more walk time on the tori, 6 %
    less on the lamp).
    Off the card the walk keeps the JAX package's rule (reordered), so the
    CPU tests hold the port to JAX like for like."""
    mode = resolved_intersector(scene)
    return mode == "packet" or (mode == "bvh" and scene.device.type != "cuda")


# Rays are reordered within fixed-size chunks rather than globally, so a ray
# never leaves its chunk and the final unsort is chunk-local too.
SORT_CHUNK = 1 << 18
SORT_ENGINES = ("auto", "count", "argsort")


def sort_chunk_size(rays: int) -> int:
    """Largest divisor of ``rays`` at most SORT_CHUNK (floor 4096; a global
    sort when none divides evenly)."""
    if rays <= SORT_CHUNK:
        return rays
    for cs in range(SORT_CHUNK, 4095, -1):
        if rays % cs == 0:
            return cs
    return rays


def pack_rows(state: RayState) -> torch.Tensor:
    """The SoA wavefront as one (R, 16) float32 block of rows ``[origin
    direction transmitted collected ray_id pad]`` (the ray id's int32 bits in
    column 12; the layout of the row kernels, ``ops/kernels/rays.py`` and
    ``bounce.shade_rows``), so a permutation moves one wide array."""
    rid = state.ray_id.contiguous().view(torch.float32)[:, None]
    pad = torch.zeros((state.origin.shape[0], 3), dtype=torch.float32,
                      device=state.origin.device)
    return torch.cat([state.origin, state.direction, state.transmitted,
                      state.collected, rid, pad], dim=1)


def unpack_rows(packed: torch.Tensor) -> RayState:
    """A ``RayState`` of column views of packed rows (the ray ids copied out)."""
    return RayState(
        origin=packed[:, 0:3],
        direction=packed[:, 3:6],
        transmitted=packed[:, 6:9],
        collected=packed[:, 9:12],
        ray_id=packed[:, 12].detach().contiguous().view(torch.int32),
    )


def sort_key_mode(scene: Scene) -> str:
    """The reorder's key: "cullhit" (the first two slab-hit cluster ids) for a
    packet scene with ``sort_key`` "cullhit" or "auto", else "morton", as
    the JAX package resolves it."""
    key_mode = scene.config.sort_key
    if key_mode == "auto":
        key_mode = "cullhit"
    if key_mode == "cullhit" and resolved_intersector(scene) == "packet":
        return "cullhit"
    return "morton"


def _sort_engine(scene: Scene, chunk: int) -> str:
    """The sort engine of a ``chunk``-ray sort; rejects an unknown engine."""
    engine = scene.config.sort_engine
    if engine not in SORT_ENGINES:
        raise ValueError(f"unknown sort_engine {engine!r}; expected one of {SORT_ENGINES}")
    if engine == "auto":
        engine = "count" if chunk <= 1 << 17 else "argsort"
    return engine


def sort_keys(scene: Scene, rows: torch.Tensor, chunk: int):
    """The reorder's keys of packed rows, ``chunk``-local → (keys (n,)
    int64, live rows (1,) int32 on the device): ``rays.ray_keys`` for the
    Morton key, ``rays.cullhit_keys`` for "cullhit", each the whole key for
    the ``"argsort"`` engine or its bucket for ``"count"`` (the JAX package's
    matmul counting sort, ``ops/sort.py``, is a TPU device), with the chunk
    index above the key."""
    count = _sort_engine(scene, chunk) == "count"
    if sort_key_mode(scene) == "cullhit":
        return rays_kernel.cullhit_keys(rows, scene.cluster_min, scene.cluster_max,
                                        scene.num_clusters, scene.config.cull_split, count,
                                        chunk)
    return rays_kernel.ray_keys(rows, scene.min_coord, scene.inv_extent, count, chunk)


def sort_order(scene: Scene, rows: torch.Tensor, chunk: int):
    """The reorder's permutation of packed rows, ``chunk``-local → (order
    (n,) int64, live rows (1,) int32 on the device). Both of the JAX
    package's engines are stable sorts, so each one's permutation is one
    stable torch sort of ``sort_keys``; the chunk index above the key keeps
    every ray in its chunk. Dead rays land last in every chunk."""
    keys, live = sort_keys(scene, rows, chunk)
    return torch.argsort(keys, stable=True), live


def reorder_rays(scene: Scene, state: RayState, chunk_size: int = None) -> RayState:
    """Coherence-key sort of the wavefront (the reference's radix-sort step,
    raytracing.cu:238-247), chunk-local (``sort_order``); ``"auto"`` picks
    count up to 2^17-ray chunks, argsort above, as the JAX package does."""
    packed = pack_rows(state)
    R = packed.shape[0]
    with torch.no_grad():  # the permutation carries no gradient
        order, _ = sort_order(scene, packed.detach(), chunk_size or sort_chunk_size(R))
    # A plain gather: its backward scatters by the saved permutation.
    return unpack_rows(packed[order])


class BounceSchedule(NamedTuple):
    """What each bounce of an R-row trace does (``bounce_schedule``): the one
    rule ``trace_rays`` and the packed trace and its graphs
    (``render/packed.py``) follow. Hashable: the graphs are cached by it."""

    sorted: Tuple[bool, ...]  # per bounce: the wavefront is reordered after it
    chunk: int  # the reorder's chunk rows (sort_chunk_size)
    compact: bool  # reordered in one chunk: the live count is read after each sorted bounce
    sizes: Tuple[int, ...]  # the live prefix sizes, descending from R
    static_rows: Optional[Tuple[int, ...]]  # per bounce, config.live_schedule's prefix

    def rows(self, bounce: int, live_bound: int) -> Tuple[int, int]:
        """The rows of bounce ``bounce`` when every live ray sits below row
        ``live_bound`` → (n, live rows left out): the static schedule's
        prefix (what it leaves out is the certificate that makes
        render_framebuffer drop a stale schedule), else the smallest live
        prefix size that holds ``live_bound``."""
        if self.static_rows is not None:
            n = self.static_rows[bounce]
            return n, max(live_bound - n, 0)
        return next(size for size in reversed(self.sizes) if size >= live_bound), 0


def bounce_schedule(scene: Scene, R: int, bounces: int, sort_rays: bool) -> BounceSchedule:
    """The schedule of an R-row trace through ``bounces`` bounces: reordered
    after each bounce while young (``sort_depth``), never after the last
    one, and only where reordering is useful. Once the whole wavefront is
    one sort chunk, the trace reads the live count back after each sorted
    bounce and runs each bounce on the smallest static prefix that holds the
    live rays, or on ``config.live_schedule``'s prefix (dead-ray
    compaction); otherwise every bounce runs all R rows. Exact: dead rays
    are no-ops, so the all-dead suffix can be left untouched; sorting a
    prefix keeps its rays inside it, and a prefix sorted in one piece puts
    its dead rays last, so the recount is a valid bound."""
    cfg = scene.config
    sort_rays = sort_rays and reorder_is_useful(scene)
    depth = cfg.sort_depth or bounces
    chunk = sort_chunk_size(R)
    compact = sort_rays and chunk == R
    sched = cfg.live_schedule if compact else ()
    return BounceSchedule(
        sorted=tuple(sort_rays and b + 1 != bounces and b < depth for b in range(bounces)),
        chunk=chunk, compact=compact, sizes=tuple(live_prefix_sizes(scene, R)),
        static_rows=tuple(prefix_for_divisor(scene, R, sched[min(b, len(sched) - 1)])
                          for b in range(bounces)) if sched else None)


def trace_rays(
    scene: Scene,
    state: RayState,
    pass_seed,
    bounces: int,
    sort_rays: bool,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
) -> Tuple[RayState, int]:
    """``render/packed.trace_wavefront`` on the ``RayState``, the trace that
    builds an autograd graph: per bounce of ``bounce_schedule``,
    ``process_rays`` on the bounce's prefix, then the prefix reordered if the
    bounce is sorted and its live count read if compact. Returns (state,
    suspect), ``suspect`` summed over bounces. With ``checkpoint_bounces``
    (and a graph to build) each bounce's shading is recomputed in the
    backward pass, on the same prefix, instead of stored: the hit record and
    the Morton permutation are kept from the forward pass, so the backward
    pass runs no closest-hit search and no sort."""
    R = state.origin.shape[0]
    schedule = bounce_schedule(scene, R, bounces, sort_rays)
    live_bound, suspect_total = R, 0
    for bounce, do_sort in enumerate(schedule.sorted):
        with recording.span("rt.bounce"):
            n, left_out = schedule.rows(bounce, live_bound)
            recording.launching()
            out, suspect = process_rays_tiled(scene, RayState(*(leaf[:n] for leaf in state)),
                                              pass_seed, bounce, reparam=reparam,
                                              checkpoint=checkpoint_bounces)
            live_bound = min(live_bound, n)
            recording.count("bounces.sorted", int(do_sort))
            if do_sort:
                with recording.span("rt.reorder"):
                    out = reorder_rays(scene, out, chunk_size=min(schedule.chunk, n))
                if schedule.compact:
                    live_bound = recording.read_live(
                        torch.any(out.transmitted != 0.0, dim=-1).sum())
            if n < R:
                recording.launching()
                out = RayState(*(torch.cat([o, leaf[n:]]) for o, leaf in zip(out, state)))
            state = out
            suspect_total = suspect_total + suspect + left_out
    return state, suspect_total


def _row_engine(scene: Scene):
    """The packet engine that takes the set-up kernel's ray tiles ("fused" or
    "fused1"), or None when the closest hit runs ``triangle_hit``."""
    if scene.triangle_count == 0 or resolved_intersector(scene) != "packet":
        return None
    cfg = scene.config
    backend = packet_intersect.resolve_backend(cfg.packet_backend, scene.device,
                                               cfg.cluster_pack)
    return backend if backend in ("fused", "fused1") else None


def bounce_rows(scene: Scene, rows: torch.Tensor, pass_seed, bounce: int,
                plain: bool = False, live: torch.Tensor = None, tail: torch.Tensor = None,
                dielectric: torch.Tensor = None, emissive: torch.Tensor = None):
    """One forward bounce of packed rows, in place → suspect: the set-up
    kernel (alive bit, sphere hit, ray tiles), the closest hit over the
    triangles (the fused / fused1 kernels on the ray tiles, else
    ``triangle_hit``), the bounce kernel. Bit-identical to ``process_rays``
    on the same rays. With ``plain`` the set-up and the shading run their
    plain versions (torch) on any device; the closest hit is unchanged.
    ``live``, a (1,) int64 counter, gets the live rows added by the set-up,
    and ``tail``, another, the same; ``dielectric`` gets the rows the bounce
    kernel scattered off a dielectric, ``emissive`` those whose hit material
    emits. While recording, the rows a packet
    engine takes count as ``hit.rows`` (``triangle_hit`` counts its own)."""
    engine = _row_engine(scene)
    tile = scene.config.packet_tile if engine else 0
    setup = rays_kernel.plain_rays_setup if plain else rays_kernel.rays_setup
    shade_rows = bounce_kernel.plain_shade_rows if plain else bounce_kernel.shade_rows
    _, t, index, od8 = setup(rows, scene.sphere_center, scene.sphere_radius, tile, live, tail)
    t_tri = tri = None
    suspect = 0
    if engine:
        recording.count("hit.rows", rows.shape[0])
        t_tri, tri = packet_intersect.packet_tiles(scene, od8, engine,
                                                   skip=scene.config.packet_skip)
    else:
        t, index, suspect = triangle_hit(scene, rows[:, 0:3], rows[:, 3:6], t, index,
                                         two_round=bounce in TWO_ROUND_BOUNCES)
    shade_rows(scene, rows, t, index, pass_seed, bounce, t_tri, tri, dielectric, emissive)
    return suspect


def packed_bounce(scene: Scene, cur: torch.Tensor, spare: torch.Tensor, n: int, settled: int,
                  bounce: int, do_sort: bool, chunk: int, pass_seed, plain: bool = False,
                  live: torch.Tensor = None, tail: torch.Tensor = None,
                  dielectric: torch.Tensor = None, emissive: torch.Tensor = None,
                  copied=None):
    """One bounce of the packed forward trace on the first ``n`` rows of ``cur`` →
    (suspect, the live rows (1,) int32 on the device, or None unsorted):
    ``bounce_rows`` in place; then, with ``do_sort``, the prefix gathered
    into ``spare`` sorted (``sort_order`` in ``chunk``-row chunks) and the
    rows ``[n, settled)`` copied into it, by ``rays.reorder_rows`` (its plain
    version with ``plain``). What a CUDA graph of the bounce holds
    (``render/packed.py``); ``pass_seed`` may be a seed word there.
    ``copied``, a pinned (1,) int32 and a CUDA event: the live rows are
    copied into it and the event recorded once the keys are written, so the
    host can read the count while the sort and the row move run. The
    counters as ``bounce_rows``'."""
    recording.count("bounces.packed", 1)
    # Counted at 0 too, so a record without it is a program without it.
    recording.count("bounces.sorted", int(do_sort))
    recording.count("rays.launched", n)
    suspect, count = 0, None
    for lo in range(0, n, ROW_TILE):
        suspect = suspect + bounce_rows(scene, cur[lo:min(n, lo + ROW_TILE)], pass_seed, bounce,
                                        plain, live, tail, dielectric, emissive)
    if do_sort:
        with recording.span("rt.reorder"):
            keys, count = sort_keys(scene, cur[:n], chunk)
            if copied is not None:
                copied[0].copy_(count, non_blocking=True)
                copied[1].record()
            move = rays_kernel.plain_reorder_rows if plain else rays_kernel.reorder_rows
            move(cur, torch.argsort(keys, stable=True), n, settled, spare)
    return suspect, count


def _chunk_order(ray_id: torch.Tensor) -> torch.Tensor:
    """The unsort's gather order: per sort chunk, the argsort of the ids."""
    R = ray_id.shape[0]
    cs = sort_chunk_size(R)
    order = torch.argsort(ray_id.reshape(R // cs, cs), dim=1)
    return (order + torch.arange(0, R, cs, device=ray_id.device)[:, None]).reshape(R)


class _UnsortByRayId(torch.autograd.Function):
    """Rows restored to ray-id order, with a gather for a backward: ids are
    a permutation within each sort chunk, so the cotangent of row i is the
    output row of its chunk-local id (where autograd's own backward of the
    forward gather would scatter-add)."""

    @staticmethod
    def forward(ctx, collected, ray_id):
        ctx.save_for_backward(ray_id)
        return collected[_chunk_order(ray_id)]

    @staticmethod
    def backward(ctx, grad):
        (ray_id,) = ctx.saved_tensors
        R = ray_id.shape[0]
        cs = sort_chunk_size(R)
        ids = ray_id.reshape(R // cs, cs).long()
        # Subtract each chunk's base: a block that does not start at ray 0
        # (pipeline._render_block) must still index inside its chunk.
        local = ids - ids.amin(dim=1, keepdim=True)
        rows = grad.reshape(R // cs, cs, -1)
        out = torch.gather(rows, 1, local[:, :, None].expand(-1, -1, rows.shape[2]))
        return out.reshape(grad.shape), None


def _unsort_by_ray_id(collected: torch.Tensor, ray_id: torch.Tensor) -> torch.Tensor:
    """``collected`` rows restored to ray-id order. Reordering is
    chunk-local, so chunk c holds exactly ids [base + c cs, base + (c+1) cs)
    and the unsort is a per-chunk argsort + gather; its backward is the
    per-chunk gather by chunk-local id (``_UnsortByRayId``)."""
    return _UnsortByRayId.apply(collected, ray_id)


def accumulate_radiance(
    state: RayState,
    rays_per_pixel: int,
    num_pixels: int,
    ordered: bool = False,
) -> torch.Tensor:
    """Per-pixel radiance sums of a (possibly reordered) wavefront: unsort
    by ray id (skipped when ``ordered``), then a reshape-sum (rays are
    pixel-major)."""
    collected = state.collected
    if not ordered:
        collected = _unsort_by_ray_id(collected, state.ray_id)
    return collected.reshape(num_pixels, rays_per_pixel, 3).sum(dim=1)
