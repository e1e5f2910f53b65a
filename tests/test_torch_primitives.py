"""Primitives of the PyTorch port against the JAX package, on the same inputs.

Inputs are made with NumPy from a seed and handed to both. Integer results
(PCG draws, seeds, hit indices, PNG bytes) must be EQUAL; float results
agree within the stated tolerances (transcendentals differ between libms by
ulps, so sin/cos-dependent values get 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.models import scene_dsl as jdsl
from cuda_raytracer_tpu.ops import bloom as jbloom
from cuda_raytracer_tpu.ops import camera as jcamera
from cuda_raytracer_tpu.ops import envmap as jenvmap
from cuda_raytracer_tpu.ops import intersect as jintersect
from cuda_raytracer_tpu.ops import rng as jrng
from cuda_raytracer_tpu.ops import tonemap as jtonemap
from cuda_raytracer_tpu.ops import vecmath as jvecmath
from cuda_raytracer_tpu.render import wavefront as jwavefront
from cuda_raytracer_tpu.utils import png as jpng

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.models import scene_dsl as tdsl
from cuda_raytracer_tpu_torch.ops import bloom, camera, envmap, intersect, rng, tonemap, vecmath
from cuda_raytracer_tpu_torch.ops.kernels import rays
from cuda_raytracer_tpu_torch.utils import png


def _seeds(n=100_000):
    seeds = np.random.default_rng(0).integers(0, 1 << 32, n, dtype=np.uint64)
    seeds[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return seeds.astype(np.uint32)


def _unit(rng_, n):
    v = rng_.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_uniforms_bit_equal():
    seeds = _seeds()
    ref = np.asarray(jrng.uniforms(jnp.asarray(seeds), 5))
    got = rng.uniforms(torch.from_numpy(seeds.astype(np.int64)), 5).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    # Signed int32 carriers of the same bits give the same stream.
    signed = rng.uniforms(torch.from_numpy(seeds.view(np.int32)), 5).numpy()
    np.testing.assert_array_equal(signed, got)


def test_draw_scalings_bit_equal():
    bits = _seeds()
    tb = torch.from_numpy(bits.astype(np.int64))
    jb = jnp.asarray(bits)
    for jf, tf in ((jrng.to_01, rng.to_01), (jrng.to_02, rng.to_02),
                   (jrng.to_radians, rng.to_radians)):
        np.testing.assert_array_equal(tf(tb).numpy(), np.asarray(jf(jb)))
    a, b = bits[: 1000], bits[1000:2000]
    ref = np.asarray(jrng.on_sphere_from_bits(jnp.asarray(a), jnp.asarray(b)))
    got = rng.on_sphere_from_bits(
        torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pass_seed", [0, 7, 80, 0xFFFFFFFF])
def test_ray_and_bounce_seeds_bit_equal(pass_seed):
    ids = np.random.default_rng(1).integers(0, 1 << 31, 5000).astype(np.int32)
    ids[:2] = [0, (1 << 31) - 1]
    np.testing.assert_array_equal(
        camera.initial_ray_seeds(torch.from_numpy(ids), pass_seed).numpy(),
        np.asarray(jcamera.initial_ray_seeds(jnp.asarray(ids), pass_seed)),
    )
    for bounce in (0, 3, 14):
        np.testing.assert_array_equal(
            rays.bounce_seeds(torch.from_numpy(ids), pass_seed, bounce).numpy(),
            np.asarray(jwavefront.bounce_seeds(jnp.asarray(ids), pass_seed, bounce)),
        )


@pytest.mark.parametrize("name", ["cornell", "spheres"])
def test_generate_rays_matches_jax(name):
    text = builtin_scenes.SCENES[name]
    overrides = dict(width=13, height=7)
    js = jdsl.assemble_scene(jdsl.parse_scene_text(text), config_overrides=overrides,
                             prefer_native_bvh=False)
    ts = tdsl.assemble_scene(tdsl.parse_scene_text(text), config_overrides=overrides,
                             device="cpu")
    rpp = 3
    ids = np.arange(13 * 7 * rpp, dtype=np.int32)
    for seed in (0, 19):
        jo, jd = jcamera.generate_rays(js.camera, 13, rpp, jnp.asarray(ids), seed)
        to, td = camera.generate_rays(ts.camera, 13, rpp, torch.from_numpy(ids), seed)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def _rays(n=512, seed=2):
    r = np.random.default_rng(seed)
    origin = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    return origin, _unit(r, n)


def test_intersect_spheres_matches_jax():
    origin, direction = _rays()
    r = np.random.default_rng(3)
    center = r.uniform(-4, 4, (9, 3)).astype(np.float32)
    radius = r.uniform(0.2, 2.0, 9).astype(np.float32)
    center[5], radius[5] = center[2], radius[2]  # exact tie: first index wins
    center[8], radius[8] = 1e17, 0.0  # padding sphere
    jt, ji = jintersect.intersect_spheres(*map(jnp.asarray, (origin, direction, center, radius)))
    tt, ti = intersect.intersect_spheres(*map(torch.from_numpy, (origin, direction, center, radius)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    assert (ti.numpy() != 5).all() and (ti.numpy() >= 0).any()


def _triangles(n=40, seed=4):
    r = np.random.default_rng(seed)
    p1 = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    e1 = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    e2 = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    p1[7], e1[7], e2[7] = p1[3], e1[3], e2[3]  # exact tie: first index wins
    p1[-1], e1[-1], e2[-1] = 1e17, 0.0, 0.0  # padding triangle
    return p1, e1, e2


def test_intersect_triangles_brute_matches_jax():
    origin, direction = _rays()
    p1, e1, e2 = _triangles()
    args = (origin, direction, p1, e1, e2)
    jt, ji = jintersect.intersect_triangles_brute(*map(jnp.asarray, args))
    tt, ti = intersect.intersect_triangles_brute(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    assert (ti.numpy() != 7).all() and (ti.numpy() >= 0).sum() > 50


def test_moller_trumbore_matches_jax():
    origin, direction = _rays(40)
    args = (origin, direction) + _triangles()
    ref = np.asarray(jintersect.moller_trumbore(*map(jnp.asarray, args)))
    got = intersect.moller_trumbore(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got == intersect.MISS, ref == jintersect.MISS)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (8, 8), (6, 10)])
def test_sample_environment_matches_jax(size, bilinear):
    r = np.random.default_rng(6)
    env = r.uniform(0, 5, size + (3,)).astype(np.float32)
    d = _unit(r, 700)
    d[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    ref = np.asarray(jenvmap.sample_environment(jnp.asarray(env), jnp.asarray(d), bilinear))
    got = envmap.sample_environment(torch.from_numpy(env), torch.from_numpy(d), bilinear)
    if bilinear:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # A texel-boundary rounding flip may pick the neighbour: ≥ 99 % equal.
        assert (np.abs(got.numpy() - ref).max(axis=1) == 0).mean() >= 0.99


def test_vecmath_matches_jax():
    r = np.random.default_rng(7)
    a = r.normal(size=(100, 3)).astype(np.float32)
    b = r.normal(size=(100, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tf, jf in ((vecmath.dot, jvecmath.dot), (vecmath.cross, jvecmath.cross),
                   (vecmath.reflect, jvecmath.reflect)):
        np.testing.assert_allclose(tf(ta, tb).numpy(), np.asarray(jf(ja, jb)), rtol=1e-6, atol=1e-6)
    for tf, jf in ((vecmath.normalise, jvecmath.normalise),
                   (vecmath.normalise_safe, jvecmath.normalise_safe),
                   (vecmath.magnitude, jvecmath.magnitude),
                   (vecmath.clamp01, jvecmath.clamp01)):
        np.testing.assert_allclose(tf(ta).numpy(), np.asarray(jf(ja)), rtol=1e-6, atol=1e-7)


def _framebuffer(h=24, w=20, rpp=4):
    r = np.random.default_rng(8)
    fb = r.exponential(1.0, (h, w, 3)).astype(np.float32) * rpp * 0.3
    fb[r.random((h, w)) < 0.05] *= 40.0  # bright pixels for the high pass
    return fb


def test_bloom_and_tonemap_match_jax():
    rpp = 4
    fb = _framebuffer(rpp=rpp)
    jb = np.array(jbloom.apply_bloom(jnp.asarray(fb), rpp))
    tb = bloom.apply_bloom(torch.from_numpy(fb), rpp).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-6)
    jd = np.array(jtonemap.tonemap(jnp.asarray(jb), 1.5, rpp))
    td = tonemap.tonemap(torch.from_numpy(jb), 1.5, rpp).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    np.testing.assert_array_equal(
        tonemap.to_bytes(torch.from_numpy(jd)).numpy(), np.asarray(jtonemap.to_bytes(jnp.asarray(jd)))
    )


def test_png_bytes_equal_jax_writer(tmp_path):
    image = np.random.default_rng(9).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "port.png"), image)
    jpng.write_png(str(tmp_path / "jax.png"), image)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")), image)
