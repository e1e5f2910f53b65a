"""One bounce's shading of a mesh wavefront: wrapper of ``csrc/bounce.cu``.

Counterpart of the shading half of ``cuda_raytracer_tpu/render/wavefront.py``
(``process_rays``, which XLA fuses into one program per bounce; there is no
Pallas kernel). ``shade_rows`` shades a packed wavefront (rows ``[origin
direction transmitted collected ray_id pad]``, ``wavefront.pack_rows``) in
place, given each row's sphere hit and, optionally, the packet kernel's raw
triangle hit, which it folds as ``packet_intersect._finalize`` does: the hit
record's material and normal gathers plus ``wavefront.shade`` with
``reparam=False`` (PCG draws, environment fetch on a miss, emission, rough
normal, metallicity coin or Schlick + total internal reflection, scatter;
dead rays unchanged). ``packed.trace_packed`` takes it for every forward
bounce. Training shades with torch (``wavefront.process_rays``).

- On a CUDA tensor it launches the hand-written kernel, one thread per ray,
  and counts the launch in ``LAUNCHES``. It never falls back.
- On a CPU tensor it runs the plain version, the torch shading. The two
  agree to the shade kernel's gate (libm sin / cos / atan differ by ulps);
  on the card every path shades through the kernel, so regimes, packings,
  resumes and ranks keep identical bits there.

Given a ``dielectric`` counter (``utils/metrics``' ``shade.dielectric``),
both add to it the rows they scattered off a dielectric (a live hit on a
material of ior > 0), reflected or refracted; given an ``emissive`` one
(``shade.emissive``), the rows whose hit material emits (a live hit on a
material with an emitted component > 0), the rows that add light. The rows
are the same with and without them.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene, derived
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.ops.kernels import build
from cuda_raytracer_tpu_torch.ops.kernels.cull import device_kind, raise_on_error

MATERIAL_FIELDS = ("diffuse_albedo", "specular_albedo", "emitted", "metallicity",
                   "roughness", "index_of_refraction")
MAT_WORDS = 12  # a material row of the kernel's table (rt::kMatWords)

# Kernel launches made by shade_rows in this process (CUDA tensors only).
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
                       pass_seed, bounce: int, dielectric: torch.Tensor = None,
                       emissive: torch.Tensor = None):
    """The kernel's plain PyTorch version on a ``RayState``: the hit record's
    gathers, then ``wavefront.shade`` with the torch PCG; ``dielectric`` and
    ``emissive`` as ``shade_rows``'."""
    from cuda_raytracer_tpu_torch.render import wavefront

    alive = torch.any(state.transmitted != 0.0, dim=-1)
    hit = wavefront.gather_hit(scene, state, alive, t, hit_index)
    live_hit = alive & (hit_index >= 0)
    if dielectric is not None:
        ior = scene.materials.index_of_refraction.detach()[hit.mat_i]
        dielectric += (live_hit & (ior > 0)).sum()
    if emissive is not None:
        emitted = scene.materials.emitted.detach()[hit.mat_i]
        emissive += (live_hit & (emitted > 0).any(dim=-1)).sum()
    return wavefront.shade(scene, state, hit, pass_seed, bounce, plain_draws=True)


def plain_shade_rows(scene: Scene, rows: torch.Tensor, t: torch.Tensor, index: torch.Tensor,
                     pass_seed, bounce: int, t_tri: torch.Tensor = None,
                     tri: torch.Tensor = None, dielectric: torch.Tensor = None,
                     emissive: torch.Tensor = None) -> None:
    """The kernel's plain PyTorch version on packed rows, in place: the
    packet hit's fold (``packet_intersect._finalize``), then
    ``plain_shade_bounce``."""
    from cuda_raytracer_tpu_torch.render import wavefront

    n = rows.shape[0]
    if t_tri is not None:
        t, index, _ = packet_intersect._finalize(scene, t_tri, tri, None, t, index, n, 1)
    state = plain_shade_bounce(scene, wavefront.unpack_rows(rows), t, index, pass_seed, bounce,
                               dielectric, emissive)
    rows[:, 0:12] = torch.cat(list(state[:4]), dim=1)


def _check(scene: Scene, rows: torch.Tensor, t: torch.Tensor, index: torch.Tensor,
           t_tri: torch.Tensor, tri: torch.Tensor, counters, pass_seed) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 16:
        raise ValueError(f"rows must be (n, 16) float32, got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    if rows.device != scene.device:
        raise ValueError(f"rows lie on {rows.device}, the scene on {scene.device}")
    n = rows.shape[0]
    hits = (("t", t, torch.float32, n), ("hit_index", index, torch.int32, n))
    if (t_tri is None) != (tri is None):
        raise ValueError("t_tri and tri come together")
    if t_tri is not None:
        hits += (("t_tri", t_tri, torch.float32, None), ("tri", tri, torch.int32, None))
    for name, x, dtype, size in hits:
        if x.dtype != dtype or not x.is_contiguous() or (
                x.numel() < n if size is None else x.shape != (n,)):
            raise ValueError(f"{name} must be a contiguous {dtype} of {n} rays, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != scene.device:
            raise ValueError(f"{name} lies on {x.device}, the scene on {scene.device}")
    for name, counter in counters.items():
        if counter is not None and (counter.dtype != torch.int64 or counter.shape != (1,)
                                    or counter.device != scene.device):
            raise ValueError(f"{name} must be a (1,) int64 tensor on the scene's device")
    if isinstance(pass_seed, torch.Tensor) and (
            pass_seed.dtype != torch.int32 or pass_seed.shape != (1,)
            or pass_seed.device != scene.device):
        raise ValueError("a seed word must be a (1,) int32 tensor on the scene's device")


def library() -> build.Built:
    """Build (at first use) and bind ``csrc/bounce.cu``."""
    built = build.load("bounce")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = built.lib.rt_bounce_rows
    fn.argtypes = [p, i, p, p, p, p] + [p, i, p, p, i, i, p, i, p, p, i, i] + [u, p, u, p, p, p]
    fn.restype = ctypes.c_int
    built.lib.rt_error_string.argtypes = [ctypes.c_int]
    built.lib.rt_error_string.restype = ctypes.c_char_p
    return built


def kernel_args(scene: Scene, rows: torch.Tensor, t: torch.Tensor, index: torch.Tensor,
                pass_seed, bounce: int, t_tri: torch.Tensor = None,
                tri: torch.Tensor = None, dielectric: torch.Tensor = None,
                emissive: torch.Tensor = None) -> list:
    """The arguments of ``rt_bounce_rows`` (and of its host build) for one
    call, without the stream. ``pass_seed`` is a number, or a seed word: a
    (1,) int32 tensor on the rows' device holding its low 32 bits, which the
    kernel reads when it runs."""
    env = scene.environment_map
    word = pass_seed if isinstance(pass_seed, torch.Tensor) else None
    return [
        rows.data_ptr(), rows.shape[0], t.data_ptr(), index.data_ptr(),
        t_tri.data_ptr() if t_tri is not None else None,
        tri.data_ptr() if tri is not None else None,
        scene.material_index.data_ptr(), scene.material_index.shape[0],
        scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(),
        scene.sphere_center.shape[0], scene.sphere_count,
        scene.tri_normal.data_ptr(), scene.tri_normal.shape[0],
        material_table(scene).data_ptr(), env.data_ptr(), env.shape[0], env.shape[1],
        0 if word is not None else int(pass_seed) & 0xFFFFFFFF,
        word.data_ptr() if word is not None else None, int(bounce),
        dielectric.data_ptr() if dielectric is not None else None,
        emissive.data_ptr() if emissive is not None else None,
    ]


def _check_tables(scene: Scene) -> None:
    for name in ("material_index", "sphere_center", "sphere_radius", "tri_normal",
                 "environment_map"):
        if not getattr(scene, name).is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous")
    if scene.material_index.dtype != torch.int32:
        raise ValueError("scene.material_index must be int32")


def shade_rows(scene: Scene, rows: torch.Tensor, t: torch.Tensor, index: torch.Tensor,
               pass_seed, bounce: int, t_tri: torch.Tensor = None,
               tri: torch.Tensor = None, dielectric: torch.Tensor = None,
               emissive: torch.Tensor = None) -> None:
    """Shade the (n, 16) packed rows in place, given each row's sphere hit
    (``t``, -1 on a dead ray; ``index``, -1 on a miss) and, unless None, the
    packet kernel's per-ray triangle hit (``t_tri``, ``tri``: at least n
    values, (T, tile) as the kernel returns them). ``dielectric``, a (1,)
    int64 tensor, gets the rows scattered off a dielectric added to it;
    ``emissive``, another, the rows whose hit material emits.
    ``pass_seed`` may be a seed word on the card (``kernel_args``), as a
    launch captured into a CUDA graph takes it (``render/packed.py``)."""
    global LAUNCHES
    _check(scene, rows, t, index, t_tri, tri,
           {"dielectric": dielectric, "emissive": emissive}, pass_seed)
    if device_kind(rows, "shade_rows") == "cpu":
        plain_shade_rows(scene, rows, t, index, pass_seed, bounce, t_tri, tri, dielectric,
                         emissive)
        return
    _check_tables(scene)
    lib = library().lib
    with torch.cuda.device(rows.device):
        err = lib.rt_bounce_rows(
            *kernel_args(scene, rows, t, index, pass_seed, bounce, t_tri, tri, dielectric,
                         emissive),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    raise_on_error(lib, err, "bounce")
    LAUNCHES += 1

