"""The *Ray Tracing in One Weekend* final scene on the port (benchmark
configuration ``rtiow_final``): spheres only, each with its own material,
under a sky map, 50 bounces deep, cut to a 4 × 4 candidate grid (20
spheres, 20 materials) at 48 × 27 pixels and 4 samples.

- The scene takes the wavefront's brute path on every device: no
  triangle, a sky map and past the shade megakernel's material table, so
  neither the megakernel nor the graphs apply, and no bounce is reordered.
- The port's render through the normal path (scene text → ``scene_dsl`` →
  ``pipeline.render_framebuffer``, the configuration's render settings) is
  held against the benchmark's plain reference
  (``rtbench/reference/tracer.pixel_sums``) at the cell's own limit on the
  framebuffer's relative L1 gap, and the reference computed in bfloat16,
  the benchmark's control, fails it.
- The port's packed wavefront agrees with the JAX package's brute
  wavefront on a spread of the cut's rays over a few bounces, at the
  parity gate of ``tests/test_torch_render.py``.
- ``hit.sphere_tests`` counts the ray-sphere tests the closest hit needs:
  the live rows (``rays.live``) against the scene's spheres, not the
  padding rows, folded in with ``rays.live`` after each packed trace; the
  trace that builds a graph counts neither.
- Marked ``cuda``: the same scene on the card (the set-up and bounce
  kernels issued eagerly, 50 bounces) against the reference traced on the
  card, at the cell's limit, and against the CPU build, at a per-pixel
  gate; the counter's identity there. On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_rtiow.py -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import shade
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics
from rtbench.core.spec import load_module
from rtbench.reference import dsl as ref_dsl
from rtbench.reference import tracer as ref_tracer

REPO = Path(__file__).resolve().parents[1]
CELL = "rtiow_final.final_500spp"
CONFIG = json.loads((REPO / "rtbench" / "configs" / "rtiow_final.json").read_text())
LIMIT = json.loads((REPO / "rtbench" / "workloads" / f"{CELL}.json").read_text())[
    "limits"]["fb_rel_l1"]
RTIOW = load_module(REPO / "rtbench" / "scenes" / "rtiow_final.py")
W, H, SPP, BOUNCES = 48, 27, 4, 50
SEED = 2 ** 31 + 5
PARAMS = dict(CONFIG["scene_params"], grid_lo=-2, grid=4, sky_size=64)


@pytest.fixture(scope="module")
def rtiow_text(tmp_path_factory):
    """(the cut's scene text, the directory that holds its sky map)."""
    tmp = tmp_path_factory.mktemp("rtiow")
    text, files = RTIOW.generate(PARAMS, np.random.default_rng(SEED))
    for name, sky in files.items():
        ref_dsl.write_pfm(str(tmp / name), sky)
    return text + f"image {W} {H} {SPP} {BOUNCES} {CONFIG['exposure']}\n", tmp


@pytest.fixture(scope="module")
def rtiow(rtiow_text):
    """(parsed scene, reference scene, reference sums of every pixel)."""
    text, tmp = rtiow_text
    ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
    parsed = scene_dsl.parse_scene_text(text, base_dir=str(tmp), filename="rtiow")
    geo = ref_tracer.geometry(ref_scene, "cpu")
    sums = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, "cpu"),
                                 torch.from_numpy(ref_scene.environment_map),
                                 torch.arange(W * H), SPP, BOUNCES)
    return parsed, ref_scene, sums


def _assemble(parsed, device="cpu", **overrides):
    return scene_dsl.assemble_scene(parsed, config_overrides=dict(CONFIG["render"], **overrides),
                                    device=device)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The cell's ``fb_rel_l1``: Σ|Δ| / Σ|reference|."""
    return float((got.float().cpu() - want).abs().sum() / want.abs().sum())


def test_small_scene_has_a_material_a_sphere_and_no_triangle(rtiow):
    parsed, ref_scene, _ = rtiow
    assert len(parsed.sphere_radius) == len(parsed.material_names) == 20
    assert len(parsed.tri_p1) == 0 and ref_scene.tri_p1.shape == (0, 3)
    assert parsed.environment_map.shape == (64, 64, 3)


@pytest.mark.parametrize("engine", ["auto", "megakernel"])
def test_scene_takes_the_wavefront_brute_path(rtiow, engine):
    scene = _assemble(rtiow[0], shade_engine=engine)
    assert scene.sphere_count == 20 and scene.sphere_center.shape[0] == 24
    assert scene.material_count == 20 > shade.MAX_MATS and scene.triangle_count == 0
    assert not shade.megakernel_eligible(scene)
    assert wavefront.resolved_intersector(scene) == "brute"
    assert not wavefront.reorder_is_useful(scene) and not packed.applies(scene)
    assert wavefront.wavefront_ordered(scene, W * H * SPP, BOUNCES, True)


def test_render_matches_the_reference_within_the_cells_limit(rtiow):
    parsed, _, want = rtiow
    got = pipeline.render_framebuffer(_assemble(parsed))
    assert got.shape == want.shape and want.abs().sum() > 0
    assert _gap(got, want) <= LIMIT


def test_bfloat16_control_fails_the_cells_limit(rtiow):
    _, ref_scene, want = rtiow
    geo = ref_tracer.geometry(ref_scene, "cpu", dtype=torch.bfloat16)
    control = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, "cpu"),
                                    torch.from_numpy(ref_scene.environment_map),
                                    torch.arange(W * H), SPP, BOUNCES)
    assert _gap(control, want) > LIMIT


def test_wavefront_matches_jax(rtiow_text):
    """A spread of the cut's rays, 2 samples a pixel, 6 bounces: the JAX
    package's brute wavefront and the port's packed trace. JAX is imported
    here: the card's tests of this file run without it."""
    import jax.numpy as jnp
    from cuda_raytracer_tpu.models import scene_dsl as jdsl
    from cuda_raytracer_tpu.render import wavefront as jwavefront
    from test_torch_render import assert_agree

    text, tmp = rtiow_text
    js = jdsl.assemble_scene(jdsl.parse_scene_text(text, base_dir=str(tmp)),
                             prefer_native_bvh=False)
    ts = scene_dsl.assemble_scene(scene_dsl.parse_scene_text(text, base_dir=str(tmp)),
                                  prefer_native_bvh=False, device="cpu")
    rpp, bounces = 2, 6
    ray_id = np.arange(0, W * H * rpp, 5, dtype=np.int32)
    ref = jwavefront.make_initial_state(js, jnp.asarray(ray_id), rpp, SEED)
    ref, ref_suspect = jwavefront.trace_wavefront(js, ref, SEED, bounces, sort_rays=False)
    state = wavefront.make_initial_state(ts, torch.from_numpy(ray_id), rpp, SEED)
    state, suspect = packed.trace_wavefront(ts, state, SEED, bounces, sort_rays=False)
    assert int(ref_suspect) == suspect == 0
    assert np.asarray(ref.collected).any()
    assert_agree(state.collected.numpy(), np.asarray(ref.collected))


def test_sphere_tests_count_the_live_rows_against_the_spheres(rtiow):
    scene = _assemble(rtiow[0])
    m = metrics.Metrics()
    pipeline.render_framebuffer(scene, metrics=m)
    c = m.resolve().counters
    rows = W * H * SPP * BOUNCES  # no compaction: every row of every bounce
    assert c["rays.launched"] == rows > c["rays.live"] > 0
    assert c["hit.sphere_tests"] == c["rays.live"] * scene.sphere_count
    assert scene.sphere_count < scene.sphere_center.shape[0]  # the padding rows are not needed
    assert c["bounces.packed"] == BOUNCES and c["bounces.sorted"] == 0


def test_sphere_tests_sum_over_blocks_and_need_a_recorder(rtiow):
    """Two blocks: the tests are folded in per trace, and a trace with
    recording off adds nothing."""
    scene = _assemble(rtiow[0])
    rays = W * SPP
    m = metrics.Metrics()
    with metrics.attached(m):
        for lo in (0, rays):
            packed.trace_camera(scene, lo, rays, SPP, SEED, BOUNCES, sort_rays=True)
    packed.trace_camera(scene, 0, rays, SPP, SEED, BOUNCES, sort_rays=True)
    c = m.resolve().counters
    assert c["rays.launched"] == 2 * rays * BOUNCES > c["rays.live"] > 0
    assert c["hit.sphere_tests"] == c["rays.live"] * scene.sphere_count


def test_trace_that_builds_a_graph_counts_no_sphere_tests(rtiow):
    """``hit.sphere_tests`` lives with ``rays.live``, which only the packed
    trace counts."""
    scene = _assemble(rtiow[0])
    state = wavefront.make_initial_state(scene, torch.arange(96, dtype=torch.int32), SPP, SEED)
    m = metrics.Metrics()
    with metrics.attached(m):
        wavefront.trace_rays(scene, state, SEED, 3, sort_rays=True)
    assert m.counters["bounces.sorted"] == 0
    assert "hit.sphere_tests" not in m.counters and "rays.live" not in m.counters


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_render_matches_the_cpu_build(rtiow, cuda):
    """The card's set-up and bounce kernels, issued eagerly for 50 bounces,
    against the reference traced on the card at the cell's limit, as the
    benchmark holds them, and against the CPU build at the port's per-pixel
    gate (the two devices' sin, cos and atan differ by ulps, which can send
    a path another way); the tests are the live rows' there too."""
    parsed, ref_scene, _ = rtiow
    scene = _assemble(parsed, device=cuda)
    assert not shade.megakernel_eligible(scene) and not packed.applies(scene)
    m = metrics.Metrics()
    got = pipeline.render_framebuffer(scene, metrics=m)
    c = m.resolve().counters
    geo = ref_tracer.geometry(ref_scene, cuda)
    want = ref_tracer.pixel_sums(geo, ref_tracer.material_tensors(ref_scene, cuda),
                                 torch.from_numpy(ref_scene.environment_map).to(cuda),
                                 torch.arange(W * H, device=cuda), SPP, BOUNCES)
    cpu = pipeline.render_framebuffer(_assemble(parsed)).to(cuda)
    assert torch.isfinite(got).all()
    assert _gap(got, want.cpu()) <= LIMIT
    close = ((got - cpu).abs() <= 1e-3 * cpu.abs() + 1e-5).all(dim=1)
    assert float(close.float().mean()) >= 0.99
    assert c["rays.launched"] == W * H * SPP * BOUNCES > c["rays.live"] > 0
    assert c["hit.sphere_tests"] == c["rays.live"] * scene.sphere_count
