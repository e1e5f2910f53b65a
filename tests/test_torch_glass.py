"""The glass-teapot deployment on the port (benchmark configuration
``glass_teapot_torus``): a glass torus (ior 1.5) under a seeded sky, small.

- The port's render through the normal path (scene text → ``scene_dsl`` →
  ``pipeline.render_framebuffer``, the configuration's render settings),
  with ``intersector`` "auto" (the packet intersector on the CPU) and
  "bvh" (the plain lockstep walk), held at every pixel against the
  benchmark's plain reference (``rtbench/reference/tracer.pixel_sums``);
  the reference computed in bfloat16, the benchmark's control, must fail
  the same tolerance.
- The records this deployment adds (``utils/metrics``): ``shade.dielectric``
  against a count made here from the plain path's per-bounce hit materials,
  ``rays.live_tail`` against the plain path's live rows of bounces
  ``bounces // 2`` on, both on the diffuse torus too, and the ``rt.tail``
  span only around those bounces.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics
from rtbench.core.spec import load_module
from rtbench.reference import dsl as ref_dsl
from rtbench.reference import tracer as ref_tracer

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "rtbench" / "configs" / "glass_teapot_torus.json").read_text())
GLASS = load_module(REPO / "rtbench" / "scenes" / "glass_torus.py")
# builtin_scenes.SMALL (768 triangles) under a 32 × 32 sky
SMALL_PARAMS = dict(CONFIG["scene_params"], ring=builtin_scenes.SMALL[0],
                    tube=builtin_scenes.SMALL[1], sky_size=32)
W, H, SPP, BOUNCES = 16, 12, 2, 10
SEEDS = (3, 2 ** 31 + 7)
# Per pixel, |port - reference| <= RTOL * |reference| + ATOL. Both trace the
# same PCG streams in float32 with the upstream expression order, and on the
# CPU they agree bit for bit on these seeds; the tolerance leaves room for
# ulps of a libm function and none for a path that went another way (a
# refraction's coin or a missed triangle moves a pixel by its whole path's
# radiance). The bfloat16 reference misses its worst pixel by more than its
# own value.
RTOL, ATOL = 1e-4, 1e-5


def _scene_text(seed: int, tmp: Path) -> str:
    text, files = GLASS.generate(SMALL_PARAMS, np.random.default_rng(seed))
    for name, sky in files.items():
        ref_dsl.write_pfm(str(tmp / name), sky)
    return text + f"image {W} {H} {SPP} {BOUNCES} {CONFIG['exposure']}\n"


@pytest.fixture(scope="module", params=SEEDS)
def glass(request):
    """(scene text, sky directory, reference sums of every pixel)."""
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        text = _scene_text(request.param, tmp)
        ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
        parsed = scene_dsl.parse_scene_text(text, base_dir=str(tmp), filename="glass")
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


@pytest.mark.parametrize("intersector", ["auto", "bvh"])
def test_glass_render_matches_the_reference_at_every_pixel(glass, intersector):
    parsed, _, want = glass
    scene = _assemble(parsed, intersector=intersector)
    assert scene.materials.index_of_refraction[0] == GLASS.IOR
    got = pipeline.render_framebuffer(scene)
    assert got.shape == want.shape and want.abs().sum() > 0
    assert (_off(got, want) <= 0).all(), float(_off(got, want).max())


def test_bfloat16_control_fails_the_tolerance(glass):
    _, ref_scene, want = glass
    geo = ref_tracer.geometry(ref_scene, "cpu", dtype=torch.bfloat16)
    control = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, "cpu"),
                                    torch.from_numpy(ref_scene.environment_map),
                                    torch.arange(W * H), SPP, BOUNCES)
    assert (_off(control, want) > 0).any()


def _plain_counts(scene, rays: int, seed: int):
    """(rows scattered off a dielectric, live rows entering bounces
    ``bounces // 2`` on) of a block, counted here bounce by bounce on the
    plain ``RayState`` path from each bounce's hit materials."""
    state = wavefront.make_initial_state(scene, torch.arange(rays, dtype=torch.int32), SPP,
                                         seed)
    ior = scene.materials.index_of_refraction.detach()
    dielectric = tail = 0
    for bounce in range(BOUNCES):
        alive, _, hit_index, _ = wavefront.closest_hit_of(scene, state, bounce)
        material = scene.material_index[hit_index.clamp_min(0).long()].long()
        dielectric += int((alive & (hit_index >= 0) & (ior[material] > 0)).sum())
        if bounce >= BOUNCES // 2:
            tail += int(alive.sum())
        state, _ = wavefront.process_rays(scene, state, seed, bounce)
    return dielectric, tail


def _small(name: str, rays_per_pixel: int = SPP):
    parsed = builtin_scenes.parse_mesh_scene(name, builtin_scenes.SMALL)
    return scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=W, height=H, rays_per_pixel=rays_per_pixel,
                                      bounces=BOUNCES), device="cpu")


@pytest.mark.parametrize("name", ["glass_torus", "torus"])
def test_dielectric_and_tail_counters_match_the_plain_path(name):
    scene, rays, seed = _small(name), W * H * SPP, 9
    dielectric, tail = _plain_counts(scene, rays, seed)
    recorded = metrics.Metrics()
    with metrics.attached(recorded):
        packed.trace_camera(scene, 0, rays, SPP, seed, BOUNCES, sort_rays=True)
    counters = recorded.resolve().counters
    assert counters["shade.dielectric"] == dielectric
    assert counters["rays.live_tail"] == tail
    assert 0 < counters["rays.live_tail"] < counters["rays.live"]
    assert (dielectric > 0) == (name == "glass_torus")
    assert len(recorded.phases) and recorded.phases["rt.tail"] < recorded.phases["rt.bounce"]


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_tail_span_covers_only_the_tail_bounces():
    scene = _small("glass_torus", rays_per_pixel=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.render_framebuffer(scene)
    bounces = sorted((e for e in prof.events() if e.name == "rt.bounce"),
                     key=lambda e: e.time_range.start)
    tails = [e for e in prof.events() if e.name == "rt.tail"]
    assert len(bounces) == BOUNCES  # one pass of one block
    assert [any(_inside(t, b) for t in tails) for b in bounces] == [
        k >= BOUNCES // 2 for k in range(BOUNCES)]
    assert len(tails) == BOUNCES - BOUNCES // 2
