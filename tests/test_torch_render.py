"""The port's brute-scene render path against the JAX package, on the same scenes.

Each built-in scene's DSL text is assembled by both packages (the arrays are
equal, see test_torch_scene.py). Per-ray radiance is held to the repo's
agreement gate (tests/test_render_parity.py): at least 99.9 % of rays with
max |Δ| < 1e-3 and none non-finite — sin/cos differ between libms by ulps,
and a 1-ulp change in a direction can flip a later branch. Framebuffers sum
rays in another order than XLA, so they get a relative tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops.pallas import shade as jshade
from cuda_raytracer_tpu.render import pipeline as jpipeline
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops.kernels import shade
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront

from test_torch_scene import build_both

NAMES = ["cornell", "cornell_plus", "spheres"]

# A small scene with every branch of the shading (diffuse and emissive
# triangles, a mirror and a glass sphere, a sky): the JAX megakernel in
# interpret mode unrolls every primitive of every bounce, so its cost grows
# with the triangle count.
MIXED = """
material light diffuse 0 0 0 specular 0 0 0 emit 12 12 12
material white diffuse 0.7 0.7 0.7 roughness 0.2
material glass ior 1.5
material mirror specular 0.9 0.8 0.7 metallicity 0.8 roughness 0.1
quad white -3 0 -3 3 0 -3 3 0 3 -3 0 3
quad white -3 0 3 3 0 3 3 4 3 -3 4 3
quad light -1 3.99 -1 1 3.99 -1 1 3.99 1 -1 3.99 1
sphere glass -1 1 0 0.9
sphere mirror 1.2 0.8 0.5 0.8
sky 0.2 0.3 0.5
camera position 0 2 -6 forward 0 -0.15 1 up 0 1 0 fov 45
image 16 16 2 3 1
"""
SHADE_SCENES = dict(builtin_scenes.SCENES, mixed=MIXED)


def assert_agree(got, ref):
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    diff = np.abs(got - ref).max(axis=1)
    agree = (diff < 1e-3).mean()
    assert agree >= 0.999, f"only {agree:.2%} of rays agree (worst {diff.max():.3g})"


def _jax_collected(js, ray_id, rpp, bounces, seed):
    state = jwavefront.make_initial_state(js, jnp.asarray(ray_id), rpp, seed)
    state, suspect = jwavefront.trace_wavefront(js, state, seed, bounces, sort_rays=False)
    assert int(suspect) == 0
    return np.asarray(state.collected)


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_collected_matches_jax(name):
    js, ts = build_both(builtin_scenes.SCENES[name], dict(width=8, height=8))
    rpp, bounces, seed = 2, 4, 7
    ray_id = np.arange(8 * 8 * rpp, dtype=np.int32)
    ref = _jax_collected(js, ray_id, rpp, bounces, seed)
    state = wavefront.make_initial_state(ts, torch.from_numpy(ray_id), rpp, seed)
    state, suspect = packed.trace_wavefront(ts, state, seed, bounces, sort_rays=False)
    assert suspect == 0
    assert_agree(state.collected.numpy(), ref)
    np.testing.assert_array_equal(state.ray_id.numpy(), ray_id)


@pytest.mark.parametrize("name", ["mixed", "spheres"])
def test_shade_trace_plain_matches_jax_megakernel(name):
    """shade_trace on CPU tensors (the kernel's plain version) against the
    JAX megakernel in interpret mode: the whole wavefront, and an offset,
    ragged block (ray ids 100..359) against the same rays of it."""
    js, ts = build_both(SHADE_SCENES[name], dict(width=16, height=16))
    rpp, bounces, seed = 2, 3, 1
    ray_id = np.arange(16 * 16 * rpp, dtype=np.int32)
    ref = np.asarray(jshade.shade_trace(js, jnp.asarray(ray_id), rpp, jnp.uint32(seed),
                                        bounces, interpret=True))
    launches = shade.LAUNCHES
    for lo, n in ((0, ray_id.size), (100, 260)):
        ids = torch.from_numpy(ray_id[lo:lo + n].copy())
        got = shade.shade_trace(ts, ids, rpp, seed, bounces).numpy()
        assert got.shape == (n, 3) and got.dtype == np.float32
        assert_agree(got, ref[lo:lo + n])
    assert shade.LAUNCHES == launches  # the CPU path launches no kernel


def test_megakernel_eligibility():
    _, ts = build_both(builtin_scenes.CORNELL, dict(width=4, height=4))
    assert not shade.megakernel_eligible(ts)  # "auto" keys on a CUDA device
    assert shade.megakernel_eligible(ts.with_config(shade_engine="megakernel"))
    assert not shade.megakernel_eligible(ts.with_config(shade_engine="xla"))
    assert not shade.megakernel_eligible(ts.with_config(shade_engine="megakernel"), reparam=True)
    for typo in ("megakernal", "XLA", ""):
        with pytest.raises(ValueError, match="unknown shade_engine"):
            shade.megakernel_eligible(ts.with_config(shade_engine=typo))
    many = "material m\n" + "".join(
        f"quad m {i} 0 0 {i} 1 0 {i} 1 1 {i} 0 1\n" for i in range(65)
    )
    _, big = build_both(many, dict(width=4, height=4, shade_engine="megakernel"))
    assert big.triangle_count == 130 and not shade.megakernel_eligible(big)
    textured = ts.replace(environment_map=torch.ones((4, 4, 3)))
    assert not shade.megakernel_eligible(textured.with_config(shade_engine="megakernel"))


def test_shade_trace_rejects_what_the_kernel_does_not_take():
    _, ts = build_both(builtin_scenes.SPHERES, dict(width=4, height=4))
    ids = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="bounces"):
        shade.shade_trace(ts, ids, 2, 0, shade.MAX_BOUNCES + 1)
    with pytest.raises(ValueError, match="int32"):
        shade.shade_trace(ts, ids.long(), 2, 0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        shade.shade_trace(ts, torch.arange(64, dtype=torch.int32)[::2], 2, 0, 3)
    with pytest.raises(ValueError, match="sky"):
        shade.shade_trace(ts.replace(environment_map=torch.ones((2, 2, 3))), ids, 2, 0, 3)


def test_unported_paths_raise():
    _, ts = build_both(builtin_scenes.CORNELL, dict(width=4, height=4))
    state = wavefront.make_initial_state(ts, torch.arange(16, dtype=torch.int32), 1, 0)
    # The packet intersector and the Morton reorder are ported (see
    # test_torch_mesh_render.py), and so is the BVH walk (see
    # test_torch_traverse.py): a Cornell trace through it, sorted or not,
    # gives JAX's BVH trace's radiance per ray at the agreement gate.
    js, ts_bvh = build_both(builtin_scenes.CORNELL, dict(width=4, height=4,
                                                         intersector="bvh"))
    assert wavefront.resolved_intersector(ts_bvh) == "bvh"
    for sort_rays in (False, True):
        jstate = jwavefront.make_initial_state(js, jnp.arange(16, dtype=jnp.int32), 1, 0)
        jstate, _ = jwavefront.trace_wavefront(js, jstate, 0, 2, sort_rays=sort_rays)
        traced, suspect = packed.trace_wavefront(ts_bvh, state, 0, 2, sort_rays=sort_rays)
        assert int(suspect) == 0
        got = traced.collected[torch.argsort(traced.ray_id)].numpy()
        assert_agree(got, np.asarray(jstate.collected)[np.argsort(np.asarray(jstate.ray_id))])
    traced, suspect = packed.trace_wavefront(ts.with_config(intersector="packet"),
                                                state, 0, 2, sort_rays=True)
    assert int(suspect) == 0 and sorted(traced.ray_id.tolist()) == list(range(16))
    # Reparameterised shading is ported (see test_torch_diff.py): it keeps
    # the rays in the graph and gives the detached render's radiance here
    # (a constant sky, so the bilinear fetch is the nearest one).
    reparam, _ = wavefront.process_rays(ts, state, 0, 0, reparam=True)
    plain, _ = wavefront.process_rays(ts, state, 0, 0)
    assert torch.allclose(reparam.collected, plain.collected, rtol=1e-5, atol=1e-6)
    assert torch.equal(reparam.transmitted != 0, plain.transmitted != 0)
    with pytest.raises(ValueError, match="unknown intersector"):
        wavefront.resolved_intersector(ts.with_config(intersector="clustered"))


@pytest.mark.parametrize("engine", ["auto", "megakernel"])
@pytest.mark.parametrize("name", ["cornell_plus", "spheres"])
def test_pipeline_matches_jax(name, engine):
    """Multi-pass render (5 rays/pixel in passes of 2+2+1): the raw
    framebuffer within rtol 1e-4 on ≥ 99 % of pixels, the 8-bit image within
    ±1 on ≥ 99 % of pixels."""
    overrides = dict(width=8, height=8, rays_per_pixel=5, bounces=3,
                     max_rays_per_pixel_per_pass=2)
    js, ts = build_both(builtin_scenes.SCENES[name], overrides)
    ts = ts.with_config(shade_engine=engine)
    fb_ref = np.asarray(jpipeline.render_framebuffer(js))
    fb = pipeline.render_framebuffer(ts)
    assert fb.shape == (64, 3) and torch.isfinite(fb).all()
    close = np.isclose(fb.numpy(), fb_ref, rtol=1e-4, atol=0).all(axis=1)
    assert close.mean() >= 0.99, f"{close.mean():.2%} of pixels within rtol 1e-4"
    img_ref = jpipeline.render_image(js, framebuffer=jnp.asarray(fb_ref))
    img = pipeline.render_image(ts, framebuffer=fb)
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    near = (np.abs(img.astype(int) - img_ref.astype(int)) <= 1).all(axis=2)
    assert near.mean() >= 0.99


def test_render_timed_runs_on_cpu():
    _, ts = build_both(builtin_scenes.CORNELL, dict(width=6, height=4, rays_per_pixel=2,
                                                    bounces=2))
    image, seconds = pipeline.render_timed(ts)
    assert image.shape == (4, 6, 3) and seconds > 0
