"""The desk-lamp deployment on the port (benchmark configuration
``desk_lamp``): a lamp of eight materials lit by an emissive filament inside
a glass bulb, built small (``detail`` 0.05: 4,730 triangles, every part and
material present).

- The port's render through the normal path (scene text → ``scene_dsl`` →
  ``pipeline.render_framebuffer``, the configuration's render settings),
  with ``intersector`` "auto" (the packet intersector on the CPU) and
  "bvh" (the plain lockstep walk), held at every pixel against the
  benchmark's plain reference (``rtbench/reference/tracer.pixel_sums``),
  from the configuration's camera and from one close to the bulb, whose
  paths reach the filament through the glass; the reference computed in
  bfloat16, the benchmark's control, must fail the same tolerance.
- The record this deployment adds (``utils/metrics``): ``shade.emissive``
  against a count made here from the plain path's per-bounce hit
  materials, and 0 on the diffuse torus; the host build of the bounce
  kernel (``csrc/bounce_host.cpp``) given the emissive and dielectric
  counters writes the bits it writes without them and counts what the
  plain version counts.
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import bounce, build
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics
from rtbench.core.spec import load_module
from rtbench.reference import dsl as ref_dsl
from rtbench.reference import tracer as ref_tracer

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "rtbench" / "configs" / "desk_lamp.json").read_text())
LAMP = load_module(REPO / "rtbench" / "scenes" / "desk_lamp.py")
DETAIL = 0.05
W, H, SPP, BOUNCES = 16, 12, 2, 10
SEED = 2 ** 31 + 11


def _bulb_camera() -> dict:
    """0.4 in front of the bulb, on the shade's axis, looking into it."""
    _, _, head, _, _, _, axis = LAMP.layout()
    bulb = head + LAMP.BULB_AT * axis
    return dict(position=(bulb + 0.4 * axis).tolist(), target=bulb.tolist(), fov=20)


CAMERAS = {"room": CONFIG["scene_params"]["camera"], "bulb": _bulb_camera()}
# Per pixel, |port - reference| <= RTOL * |reference| + ATOL. Both trace the
# same PCG streams in float32 with the upstream expression order, and on the
# CPU they agree bit for bit on these views; the tolerance leaves room for
# ulps of a libm function and none for a path that went another way (a
# path that reaches the filament instead of missing it moves a pixel by up
# to 500 times its throughput). The bfloat16 reference misses its worst
# pixel by more than its own value.
RTOL, ATOL = 1e-4, 1e-5


def _params(camera: str) -> dict:
    return dict(CONFIG["scene_params"], detail=DETAIL, camera=CAMERAS[camera])


def _scene_text(camera: str, seed: int = SEED) -> str:
    text, files = LAMP.generate(_params(camera), np.random.default_rng(seed))
    assert files == {}
    return text + f"image {W} {H} {SPP} {BOUNCES} {CONFIG['exposure']}\n"


@pytest.fixture(scope="module", params=list(CAMERAS))
def lamp(request):
    """(parsed scene, reference scene, reference sums of every pixel)."""
    text = _scene_text(request.param)
    ref_scene = ref_dsl.parse(text)
    parsed = scene_dsl.parse_scene_text(text, filename="lamp")
    geo = ref_tracer.geometry(ref_scene, "cpu")
    sums = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, "cpu"),
                                 torch.from_numpy(ref_scene.environment_map),
                                 torch.arange(W * H), SPP, BOUNCES)
    return parsed, ref_scene, sums


def _assemble(parsed, **overrides):
    return scene_dsl.assemble_scene(parsed, config_overrides=dict(CONFIG["render"], **overrides),
                                    device="cpu")


def _off(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each pixel's excess over the tolerance (> 0 fails)."""
    return ((got - want).abs() - (RTOL * want.abs() + ATOL)).amax(dim=1)


def test_small_lamp_has_every_part_and_material(lamp):
    parsed, ref_scene, _ = lamp
    assert len(parsed.tri_p1) == LAMP.triangle_count({"detail": DETAIL}) == 4730
    assert parsed.material_names == ref_scene.material_names == [
        "floor", "wall", "black_metal", "chrome", "reflector", "glass", "cable", "filament"]
    assert set(ref_scene.tri_material.tolist()) == set(range(8))
    sky = np.float32(CONFIG["scene_params"]["sky"])
    assert (parsed.environment_map.reshape(3) == sky).all()


@pytest.mark.parametrize("intersector", ["auto", "bvh"])
def test_lamp_render_matches_the_reference_at_every_pixel(lamp, intersector):
    parsed, _, want = lamp
    scene = _assemble(parsed, intersector=intersector)
    got = pipeline.render_framebuffer(scene)
    assert got.shape == want.shape and want.abs().sum() > 0
    assert (_off(got, want) <= 0).all(), float(_off(got, want).max())


def test_bfloat16_control_fails_the_tolerance(lamp):
    _, ref_scene, want = lamp
    geo = ref_tracer.geometry(ref_scene, "cpu", dtype=torch.bfloat16)
    control = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, "cpu"),
                                    torch.from_numpy(ref_scene.environment_map),
                                    torch.arange(W * H), SPP, BOUNCES)
    assert (_off(control, want) > 0).any()


def _emissive_rows(scene, alive, hit_index) -> torch.Tensor:
    """Live rows whose hit material emits (an emitted component > 0)."""
    material = scene.material_index[hit_index.clamp_min(0).long()].long()
    emits = (scene.materials.emitted.detach()[material] > 0).any(dim=-1)
    return alive & (hit_index >= 0) & emits


def _plain_count(scene, rays: int, seed: int) -> int:
    """The live rows whose hit material emits over a block's bounces,
    counted here bounce by bounce on the plain ``RayState`` path."""
    state = wavefront.make_initial_state(scene, torch.arange(rays, dtype=torch.int32), SPP,
                                         seed)
    emissive = 0
    for b in range(BOUNCES):
        alive, _, hit_index, _ = wavefront.closest_hit_of(scene, state, b)
        emissive += int(_emissive_rows(scene, alive, hit_index).sum())
        state, _ = wavefront.process_rays(scene, state, seed, b)
    return emissive


def _small(name: str):
    if name == "desk_lamp":
        parsed = scene_dsl.parse_scene_text(_scene_text("bulb"), filename="lamp")
    else:
        parsed = builtin_scenes.parse_mesh_scene(name, builtin_scenes.SMALL)
    return scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=W, height=H, rays_per_pixel=SPP,
                                      bounces=BOUNCES), device="cpu")


@pytest.mark.parametrize("name", ["desk_lamp", "torus"])
def test_emissive_counter_matches_the_plain_path(name):
    scene, rays, seed = _small(name), W * H * SPP, 9
    want = _plain_count(scene, rays, seed)
    recorded = metrics.Metrics()
    with metrics.attached(recorded):
        packed.trace_camera(scene, 0, rays, SPP, seed, BOUNCES, sort_rays=True)
    counters = recorded.resolve().counters
    assert counters["shade.emissive"] == want
    assert (want > 0) == (name == "desk_lamp") and want < counters["rays.live"]


@pytest.mark.parametrize("name", ["glass_torus", "desk_lamp"])
def test_walk_renders_the_same_bits_sorted_and_unsorted(name):
    """The walk with and without the reorder (its sort, live-prefix
    compaction and unsort), as the card runs it unsorted: the same
    framebuffer, and the same live rows, dielectric and emissive rows."""
    scene = _small(name).with_config(intersector="bvh")
    got = {}
    for sort_rays in (True, False):
        recorded = metrics.Metrics()
        fb = pipeline.render_framebuffer(scene.with_config(sort_rays=sort_rays),
                                         metrics=recorded)
        got[sort_rays] = fb, recorded.resolve().counters
    (fb, counters), (unsorted_fb, unsorted) = got[True], got[False]
    assert torch.equal(unsorted_fb, fb) and fb.abs().sum() > 0
    assert counters["bounces.sorted"] == 5 and unsorted["bounces.sorted"] == 0
    assert "sync.host" not in unsorted and counters["sync.host"] == 5
    for name in ("rays.live", "shade.dielectric", "shade.emissive"):
        assert unsorted[name] == counters[name]
    assert unsorted["rays.launched"] == BOUNCES * W * H * SPP >= counters["rays.launched"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = tmp_path_factory.mktemp("bounce_host") / "libbounce_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib_path), str(build.CSRC_DIR / "bounce_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.rt_host_bounce_rows.argtypes = (
        [p, i, p, p, p, p] + [p, i, p, p, i, i, p, i, p, p, i, i] + [u, p, u, p, p])
    lib.rt_host_bounce_rows.restype = ctypes.c_int
    return lib


def test_host_kernel_counts_emissive_rows_and_keeps_its_bits(host_lib):
    """Bounces 0-3 of the close-up view: the host build with both counters
    writes the rows it writes without them, and counts the rows whose hit
    emits and those scattered off the glass as the plain version and a
    count from the hit materials do."""
    scene = _small("desk_lamp")
    seed, rays = 6, W * H * SPP
    state = wavefront.make_initial_state(scene, torch.arange(rays, dtype=torch.int32), SPP,
                                         seed)
    ior = scene.materials.index_of_refraction
    totals = np.zeros(2, np.int64)
    for b in range(4):
        alive, t, hit_index, _ = wavefront.closest_hit_of(scene, state, b)
        material = scene.material_index[hit_index.clamp_min(0).long()].long()
        want = (int((alive & (hit_index >= 0) & (ior[material] > 0)).sum()),
                int(_emissive_rows(scene, alive, hit_index).sum()))
        rows = wavefront.pack_rows(state)
        counted = rows.clone()
        counters = [torch.zeros(1, dtype=torch.int64) for _ in range(4)]
        assert host_lib.rt_host_bounce_rows(
            *bounce.kernel_args(scene, rows, t, hit_index, seed, b)) == 0
        assert host_lib.rt_host_bounce_rows(
            *bounce.kernel_args(scene, counted, t, hit_index, seed, b,
                                dielectric=counters[0], emissive=counters[1])) == 0
        assert torch.equal(rows.view(torch.int32), counted.view(torch.int32))
        state = bounce.plain_shade_bounce(scene, state, t, hit_index, seed, b, *counters[2:])
        assert [int(c) for c in counters] == [*want, *want]
        totals += want
    assert (totals > 0).all()
