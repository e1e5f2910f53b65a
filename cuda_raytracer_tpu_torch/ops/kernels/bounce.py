"""One bounce's shading of a mesh wavefront: wrapper of ``csrc/bounce.cu``.

Counterpart of the shading half of ``cuda_raytracer_tpu/render/wavefront.py``
(``process_rays``, which XLA fuses into one program per bounce; there is no
Pallas kernel). ``shade_bounce`` takes a wavefront's state and its closest
hit (``t``, ``hit_index``) and returns the next state: the hit record's
material and normal gathers plus ``wavefront.shade`` with ``reparam=False``
(PCG draws, environment fetch on a miss, emission, rough normal, metallicity
coin or Schlick + total internal reflection, scatter, merge; dead rays
unchanged). ``wavefront.process_rays`` takes it for every forward bounce
that builds no autograd graph; training shades with torch.

- On a CUDA tensor it launches the hand-written kernel, one thread per ray,
  and counts the launch in ``LAUNCHES``. It never falls back.
- On a CPU tensor it runs ``plain_shade_bounce``, the torch shading. The two
  agree to the shade kernel's gate (libm sin / cos / atan differ by ulps);
  on the card every path shades through the kernel, so regimes, packings,
  resumes and ranks keep identical bits there.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene, derived
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, raise_on_error

MATERIAL_FIELDS = ("diffuse_albedo", "specular_albedo", "emitted", "metallicity",
                   "roughness", "index_of_refraction")
MAT_WORDS = 12  # a material row of the kernel's table (rt::kMatWords)

# Kernel launches made by shade_bounce in this process (CUDA tensors only).
LAUNCHES = 0


def material_table(scene: Scene) -> torch.Tensor:
    """(M, 12) float32 rows ``[diffuse specular emitted metallicity roughness
    ior]`` on the scene's device, built once per material set."""
    mats = scene.materials
    leaves = tuple(getattr(mats, f) for f in MATERIAL_FIELDS)

    def build_table():
        with torch.no_grad():
            cols = [x if x.dim() == 2 else x[:, None] for x in leaves]
            return torch.cat(cols, dim=1).contiguous()

    return derived(("bounce_materials",), leaves, build_table)


def plain_shade_bounce(scene: Scene, state, t: torch.Tensor, hit_index: torch.Tensor,
                       pass_seed, bounce: int):
    """The kernel's plain PyTorch version: the hit record's gathers, then
    ``wavefront.shade``."""
    from cuda_raytracer_tpu_torch.render import wavefront

    alive = torch.any(state.transmitted != 0.0, dim=-1)
    hit = wavefront.gather_hit(scene, state, alive, t, hit_index)
    return wavefront.shade(scene, state, hit, pass_seed, bounce)


def _check(scene: Scene, state, t: torch.Tensor, hit_index: torch.Tensor) -> None:
    rays = state.origin.shape[0]
    for name, leaf in zip(("origin", "direction", "transmitted", "collected"), state[:4]):
        if leaf.dtype != torch.float32 or leaf.shape != (rays, 3):
            raise ValueError(f"{name} must be ({rays}, 3) float32, got {leaf.dtype} "
                             f"{tuple(leaf.shape)}")
        if rays and leaf.stride(1) != 1:
            raise ValueError(f"{name} rows must have unit column stride")
    for name, x, dtype in (("ray_id", state.ray_id, torch.int32), ("t", t, torch.float32),
                           ("hit_index", hit_index, torch.int32)):
        if x.dtype != dtype or x.shape != (rays,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({rays},) {dtype}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (*state, t, hit_index):
        if x.device != scene.device:
            raise ValueError(f"an input lies on {x.device}, the scene on {scene.device}")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/bounce.cu``."""
    built = build.load("bounce")
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    fn = built.lib.rt_shade_bounce
    fn.argtypes = ([p, ll] * 4 + [p] * 3 + [i] + [p, i, p, p, i, i, p, i, p, p, i, i]
                   + [u, u, p, p])
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def kernel_args(scene: Scene, state, t: torch.Tensor, hit_index: torch.Tensor,
                pass_seed, bounce: int, out: torch.Tensor) -> list:
    """The arguments of ``rt_shade_bounce`` (and of its host build) for one
    call, without the stream; ``out`` is the (R, 12) float32 result."""
    rows = []
    for leaf in state[:4]:
        rows += [leaf.data_ptr(), leaf.stride(0)]
    env = scene.environment_map
    return rows + [
        state.ray_id.data_ptr(), t.data_ptr(), hit_index.data_ptr(), state.origin.shape[0],
        scene.material_index.data_ptr(), scene.material_index.shape[0],
        scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(),
        scene.sphere_center.shape[0], scene.sphere_count,
        scene.tri_normal.data_ptr(), scene.tri_normal.shape[0],
        material_table(scene).data_ptr(), env.data_ptr(), env.shape[0], env.shape[1],
        int(pass_seed) & 0xFFFFFFFF, int(bounce), out.data_ptr(),
    ]


def _check_tables(scene: Scene) -> None:
    for name in ("material_index", "sphere_center", "sphere_radius", "tri_normal",
                 "environment_map"):
        if not getattr(scene, name).is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous")
    if scene.material_index.dtype != torch.int32:
        raise ValueError("scene.material_index must be int32")


def state_from_rows(state, out: torch.Tensor):
    """The next state as column views of the (R, 12) kernel output."""
    return state._replace(origin=out[:, 0:3], direction=out[:, 3:6],
                          transmitted=out[:, 6:9], collected=out[:, 9:12])


def shade_bounce(scene: Scene, state, t: torch.Tensor, hit_index: torch.Tensor,
                 pass_seed, bounce: int):
    """One bounce's shading of ``state`` (a ``wavefront.RayState``) given its
    closest hit → the next state (ray ids unchanged)."""
    global LAUNCHES
    _check(scene, state, t, hit_index)
    if device_kind(state.origin, "shade_bounce") == "cpu":
        return plain_shade_bounce(scene, state, t, hit_index, pass_seed, bounce)
    _check_tables(scene)
    out = torch.empty((state.origin.shape[0], 12), dtype=torch.float32,
                      device=state.origin.device)
    lib = library().lib
    with torch.cuda.device(out.device):
        err = lib.rt_shade_bounce(
            *kernel_args(scene, state, t, hit_index, pass_seed, bounce, out),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    raise_on_error(lib, err, "bounce")
    LAUNCHES += 1
    return state_from_rows(state, out)
