"""Whole-pass brute-scene kernel: wrapper of ``csrc/shade.cu``.

Counterpart of ``cuda_raytracer_tpu/ops/pallas/shade.py``. ``shade_trace``
traces a block of rays through the whole pass (camera ray, every bounce's
closest hit and shading, the PCG chain) and returns the collected radiance
``(R, 3)`` that the pass loop accumulates.

- On a CUDA tensor it launches the hand-written kernel on its persistent
  grid (the blocks resident on the card at once; each lane traces one path
  and then takes the next ray id) and counts the launch in ``LAUNCHES``. It
  never falls back. ``trace_on_grid`` launches it on another grid, with the
  same bits.
- On a CPU tensor it runs the kernel's plain version: the wavefront path
  (``make_initial_state`` → ``trace_packed(sort_rays=False)`` →
  ``collected``) with torch's camera draws, set-up and shading on any
  device (``plain=True``), which the JAX package holds its own megakernel
  to bit-identity with.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import raise_on_error
from cuda_raytracer_tpu_torch.render import packed, wavefront

# Table limits: every shipped brute scene fits with slack (cornell_plus has
# 34 primitives). The bounce limit is the JAX kernel's (its seed table held
# 15 bounce terms); the CUDA kernel computes its seed terms itself.
MAX_SPHERES = 32
MAX_TRIS = 128
MAX_MATS = 16
MAX_BOUNCES = 15
SHADE_ENGINES = ("auto", "xla", "megakernel")

# Packed table layout, in 32-bit words (must match csrc/brute.cuh).
HEAD_WORDS = 24  # camera [0, 14), sky [14, 17), padding
SPHERE_WORDS = 8  # cx cy cz r mat pad pad pad
TRI_WORDS = 16  # p1 e1 e2 normal mat pad pad pad
MAT_WORDS = 12  # diffuse specular emitted metallicity roughness ior

# Kernel launches made by shade_trace in this process (CUDA tensors only).
LAUNCHES = 0


def megakernel_eligible(scene: Scene, reparam: bool = False) -> bool:
    """True when shade_trace can trace this scene: brute triangle path,
    constant sky, table-sized counts, forward rendering. With
    ``shade_engine="auto"`` the kernel is used on a CUDA device only; on the
    CPU the wavefront path runs. A brute scene it cannot take (more than
    MAX_SPHERES spheres, MAX_TRIS triangles or MAX_MATS materials, or a sky
    map) runs the wavefront's brute path on the card too: per bounce the
    set-up kernel (``rays.rays_setup``), whose loop over every sphere row is
    the closest hit, then the bounce kernel, every bounce on all the block's
    rows."""
    engine = scene.config.shade_engine
    if engine not in SHADE_ENGINES:
        raise ValueError(
            f"unknown shade_engine {engine!r}; expected one of {SHADE_ENGINES}"
        )
    if engine == "xla" or reparam:
        return False
    if engine == "auto" and scene.device.type != "cuda":
        return False
    if wavefront.resolved_intersector(scene) != "brute":
        return False
    env = scene.environment_map
    if env.shape[0] * env.shape[1] != 1:
        return False
    return (
        scene.sphere_count <= MAX_SPHERES
        and scene.triangle_count <= MAX_TRIS
        and scene.material_count <= MAX_MATS
    )


def pack_table(scene: Scene) -> torch.Tensor:
    """The kernel's scene table, float32 words on the scene's device, built
    with device ops only: camera and sky, then the sphere, triangle and
    material rows at their true counts."""
    S, T, M = scene.sphere_count, scene.triangle_count, scene.material_count
    dev = scene.device
    f32 = torch.float32
    cam = scene.camera
    head = torch.cat([
        cam.position, cam.near_plane_top_left, cam.scaled_right, cam.scaled_up,
        cam.inv_width.reshape(1), cam.inv_height.reshape(1),
        scene.environment_map.reshape(-1)[:3],
        torch.zeros(7, dtype=f32, device=dev),
    ])

    def pad(cols, width):
        rows = torch.cat(cols, dim=1)
        return torch.nn.functional.pad(rows, (0, width - rows.shape[1])).reshape(-1)

    mat_ids = scene.material_index.to(f32)[:, None]
    sph = pad([scene.sphere_center[:S], scene.sphere_radius[:S, None], mat_ids[:S]],
              SPHERE_WORDS)
    tri = pad([scene.tri_p1[:T], scene.tri_e1[:T], scene.tri_e2[:T],
               scene.tri_normal[:T], mat_ids[S:S + T]], TRI_WORDS)
    mats = scene.materials
    mat = pad([mats.diffuse_albedo[:M], mats.specular_albedo[:M], mats.emitted[:M],
               mats.metallicity[:M, None], mats.roughness[:M, None],
               mats.index_of_refraction[:M, None]], MAT_WORDS)
    return torch.cat([head, sph, tri, mat]).contiguous()


def plain_trace(
    scene: Scene, ray_id: torch.Tensor, rays_per_pixel: int, pass_seed, bounces: int
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the wavefront brute path, on
    torch alone on every device (the camera's PCG, the sphere and triangle
    tests, the shading), so it shares no device code with the kernel."""
    state = wavefront.make_initial_state(scene, ray_id, rays_per_pixel, pass_seed, plain=True)
    state, _ = packed.trace_packed(scene, state, pass_seed, bounces, sort_rays=False, plain=True)
    return state.collected


def _check(scene: Scene, ray_id: torch.Tensor, rays_per_pixel: int, bounces: int):
    if bounces > MAX_BOUNCES or bounces < 0:
        raise ValueError(f"shade kernel supports 0..{MAX_BOUNCES} bounces, got {bounces}")
    if rays_per_pixel < 1:
        raise ValueError(f"rays_per_pixel must be >= 1, got {rays_per_pixel}")
    if ray_id.dtype != torch.int32 or ray_id.dim() != 1:
        raise ValueError(f"ray_id must be a 1-D int32 tensor, got {ray_id.dtype} "
                         f"{tuple(ray_id.shape)}")
    if ray_id.device != scene.device:
        raise ValueError(f"ray_id on {ray_id.device}, scene on {scene.device}")
    if not ray_id.is_contiguous():
        raise ValueError("ray_id must be contiguous")
    if wavefront.resolved_intersector(scene) != "brute":
        raise ValueError("shade kernel traces brute scenes only")
    env = scene.environment_map
    if env.shape[0] * env.shape[1] != 1:
        raise ValueError("shade kernel needs a constant (1x1) sky")
    if (scene.sphere_count > MAX_SPHERES or scene.triangle_count > MAX_TRIS
            or scene.material_count > MAX_MATS):
        raise ValueError(
            f"scene exceeds the kernel tables: {scene.sphere_count}/{MAX_SPHERES} "
            f"spheres, {scene.triangle_count}/{MAX_TRIS} triangles, "
            f"{scene.material_count}/{MAX_MATS} materials"
        )


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/shade.cu``."""
    built = build.load("shade")
    fn = built.lib.rt_shade_trace
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_uint, ctypes.c_int]
        + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    grid = built.lib.rt_shade_grid
    grid.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    grid.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def persistent_grid(scene: Scene) -> tuple:
    """(blocks per SM, SMs) of the kernel's persistent grid for ``scene``'s
    table on its CUDA device: ``shade_trace`` launches their product."""
    lib = library().lib
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(scene.device):
        err = lib.rt_shade_grid(scene.sphere_count, scene.triangle_count,
                                scene.material_count, ctypes.byref(per_sm), ctypes.byref(sms))
    raise_on_error(lib, err, "shade (occupancy query)")
    return per_sm.value, sms.value


def trace_on_grid(
    scene: Scene,
    ray_id: torch.Tensor,
    rays_per_pixel: int,
    pass_seed,
    bounces: int,
    blocks: int,
) -> torch.Tensor:
    """``shade_trace`` with the kernel on ``blocks`` blocks (<= 0: the
    persistent grid). A path's radiance depends on its ray id alone, so
    every grid gives the same bits."""
    global LAUNCHES
    _check(scene, ray_id, rays_per_pixel, bounces)
    if ray_id.device.type == "cpu":
        return plain_trace(scene, ray_id, rays_per_pixel, pass_seed, bounces)
    if ray_id.device.type != "cuda":
        raise ValueError(f"shade_trace runs on CUDA or the CPU, not {ray_id.device}")
    table = pack_table(scene)
    rays = ray_id.shape[0]
    out = torch.empty((rays, 3), dtype=torch.float32, device=ray_id.device)
    next_id = torch.empty(1, dtype=torch.int32, device=ray_id.device)
    lib = library().lib
    with torch.cuda.device(ray_id.device):
        err = lib.rt_shade_trace(
            table.data_ptr(), ray_id.data_ptr(), out.data_ptr(), rays,
            rays_per_pixel, scene.config.width, bounces, scene.sphere_count,
            scene.triangle_count, scene.material_count, int(pass_seed) & 0xFFFFFFFF,
            int(blocks), next_id.data_ptr(),
            torch.cuda.current_stream(ray_id.device).cuda_stream,
        )
    raise_on_error(lib, err, "shade")
    LAUNCHES += 1
    return out


def shade_trace(
    scene: Scene,
    ray_id: torch.Tensor,  # (R,) int32 — global ray ids (whole-pixel runs)
    rays_per_pixel: int,
    pass_seed,
    bounces: int,
) -> torch.Tensor:
    """Trace ``ray_id``'s rays through the whole pass → collected radiance
    (R, 3) float32, in ray order."""
    return trace_on_grid(scene, ray_id, rays_per_pixel, pass_seed, bounces, 0)
