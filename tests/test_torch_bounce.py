"""The mesh bounce's shading kernel (``csrc/bounce.cu``) against the torch shading and JAX.

``bounce.cu`` runs only on the GPU, where ``chip_smoke.py`` holds it against
its plain version. Its per-ray body is ``rt::shade_packed_row`` in
``csrc/shading.cuh``; ``csrc/bounce_host.cpp`` runs the same body over the
rows of a packed wavefront on the host. This test builds that file with the host C++ compiler
(``-ffp-contract=off``, like the GPU build's ``-fmad=false``) and holds the
next state it writes against:

- ``bounce.plain_shade_bounce`` (the hit record's gathers and
  ``wavefront.shade``) on the same state and closest hit, for the small
  torus, the glass torus (refraction and total internal reflection) and a
  sphere scene under the substitute sky (brute intersector, texel fetches),
  entering bounces 0-3, the state packed into rows as the forward trace
  holds it;
- JAX's ``process_rays`` for one bounce on the same inputs, on the rays
  whose closest hits agree (JAX's CPU floats carry FMA contraction, so hit
  distances agree to rtol 1e-4 and indices exactly).

Tolerance, the shade kernel's gate: on at least 99.9 % of rays every
component of the next state is within 1e-3, and none is non-finite (libm
sin / cos / atan differ from torch's by ulps, which can move a texel or flip
a branch).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops.kernels import bounce, build
from cuda_raytracer_tpu_torch.render import wavefront

from test_torch_packet import build_mesh_both

AGREE_TOL = 1e-3
AGREE_MIN = 0.999
SIZE = dict(width=16, height=16, rays_per_pixel=4, bounces=4)
SCENE_TEXT = {
    "torus": builtin_scenes.torus(builtin_scenes.SMALL),
    "glass_torus": builtin_scenes.glass_torus(builtin_scenes.SMALL),
    "spheres_sky": builtin_scenes.SPHERES,
}


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


@pytest.fixture(scope="module")
def scenes():
    return {name: build_mesh_both(text, SIZE, sky=True) for name, text in SCENE_TEXT.items()}


def host_bounce(lib, scene, state, t, hit_index, pass_seed, bnc):
    """The host build of the kernel on one wavefront, packed into rows and
    shaded in place → the next RayState."""
    rows = wavefront.pack_rows(state)
    assert lib.rt_host_bounce_rows(
        *bounce.kernel_args(scene, rows, t, hit_index, pass_seed, bnc)) == 0
    return wavefront.unpack_rows(rows)


def assert_states_agree(got, ref, rows=None):
    a = torch.cat(list(got[:4]), dim=1).numpy()
    b = torch.cat(list(ref[:4]), dim=1).numpy()
    if rows is not None:
        a, b = a[rows], b[rows]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    agree = (diff < AGREE_TOL).mean()
    assert agree >= AGREE_MIN, f"{agree:.4%} of rays agree (worst {diff.max():.3g})"
    return agree


@pytest.mark.parametrize("name", list(SCENE_TEXT))
def test_host_kernel_matches_torch_shading(host_lib, scenes, name):
    """Bounces 0-3 of one pass: the host build against the plain version
    on the same state and closest hit; dead, missing and hitting rays all
    occur, and after the first reorder the state rows are strided views."""
    _, scene = scenes[name]
    seed = 5
    rays = scene.num_pixels * SIZE["rays_per_pixel"]
    state = wavefront.make_initial_state(
        scene, torch.arange(rays, dtype=torch.int32), SIZE["rays_per_pixel"], seed)
    kinds = set()
    for bnc in range(4):
        alive, t, hit_index, _ = wavefront.closest_hit_of(scene, state, bnc)
        kinds |= {"dead" if not alive.all() else "", "miss" if (alive & (hit_index < 0)).any()
                  else "", "hit" if (hit_index >= 0).any() else ""}
        ref = bounce.plain_shade_bounce(scene, state, t, hit_index, seed, bnc)
        got = host_bounce(host_lib, scene, state, t, hit_index, seed, bnc)
        assert torch.equal(got.ray_id, state.ray_id)
        assert_states_agree(got, ref)
        if wavefront.reorder_is_useful(scene):
            assert bnc == 0 or state.origin.stride(0) == 16  # the reorder's packed rows
            state = wavefront.reorder_rays(scene, ref)
        else:
            state = ref
    assert {"dead", "miss", "hit"} <= kinds


@pytest.mark.parametrize("name", list(SCENE_TEXT))
def test_host_kernel_counts_dielectric_rows_and_keeps_its_bits(host_lib, scenes, name):
    """Given a counter the host build adds the rows it scattered off a
    dielectric (a live hit on a material of ior > 0), as the plain version
    and a count from the hit materials do, and shades the same bits as
    without one; the diffuse torus has none."""
    _, scene = scenes[name]
    seed = 6
    rays = scene.num_pixels * SIZE["rays_per_pixel"]
    state = wavefront.make_initial_state(
        scene, torch.arange(rays, dtype=torch.int32), SIZE["rays_per_pixel"], seed)
    ior = scene.materials.index_of_refraction
    total = 0
    for bnc in range(4):
        alive, t, hit_index, _ = wavefront.closest_hit_of(scene, state, bnc)
        mat = scene.material_index[hit_index.clamp_min(0).long()].long()
        want = int((alive & (hit_index >= 0) & (ior[mat] > 0)).sum())
        rows = wavefront.pack_rows(state)
        counted, counter, plain = rows.clone(), torch.zeros(1, dtype=torch.int64), \
            torch.zeros(1, dtype=torch.int64)
        assert host_lib.rt_host_bounce_rows(
            *bounce.kernel_args(scene, rows, t, hit_index, seed, bnc)) == 0
        assert host_lib.rt_host_bounce_rows(
            *bounce.kernel_args(scene, counted, t, hit_index, seed, bnc,
                                dielectric=counter)) == 0
        assert torch.equal(rows.view(torch.int32), counted.view(torch.int32))
        state = bounce.plain_shade_bounce(scene, state, t, hit_index, seed, bnc, plain)
        assert int(counter) == int(plain) == want
        total += want
    assert (total > 0) == (name != "torus")


def test_host_kernel_bits_of_dead_rays_and_draws(host_lib, scenes):
    """Dead rays come out bit-identical; a ray's scatter depends on its id
    (the PCG stream), not its row."""
    _, scene = scenes["torus"]
    rays = 512
    state = wavefront.make_initial_state(scene, torch.arange(rays, dtype=torch.int32), 4, 3)
    dead = torch.arange(rays) % 5 == 0
    state = state._replace(transmitted=torch.where(dead[:, None], 0.0, state.transmitted))
    _, t, hit_index, _ = wavefront.closest_hit_of(scene, state, 0)
    got = host_bounce(host_lib, scene, state, t, hit_index, 3, 0)
    for new, old in zip(got[:4], state[:4]):
        assert torch.equal(new[dead], old[dead])
    flip = torch.flip(torch.arange(rays), [0])
    flipped = wavefront.RayState(*(leaf[flip].contiguous() for leaf in state))
    got_flipped = host_bounce(host_lib, scene, flipped, t[flip].contiguous(),
                              hit_index[flip].contiguous(), 3, 0)
    for a, b in zip(got_flipped[:4], got[:4]):
        assert torch.equal(a, b[flip])


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 80, 2**32 - 1])
def test_host_kernel_reads_the_pass_seed_from_a_word(host_lib, scenes, seed):
    """Given a seed word (the pass seed's low 32 bits as one int32, as a
    CUDA graph's launch takes it) the host build shades the bits it shades
    given the seed itself, whatever the argument says."""
    _, scene = scenes["glass_torus"]
    rays = 512
    state = wavefront.make_initial_state(scene, torch.arange(rays, dtype=torch.int32), 4, 3)
    _, t, hit_index, _ = wavefront.closest_hit_of(scene, state, 0)
    want = wavefront.pack_rows(state)
    got = want.clone()
    assert host_lib.rt_host_bounce_rows(
        *bounce.kernel_args(scene, want, t, hit_index, seed, 2)) == 0
    word = torch.tensor([seed & 0xFFFFFFFF], dtype=torch.int64).to(torch.int32)
    args = bounce.kernel_args(scene, got, t, hit_index, word, 2)
    assert args[18] == 0 and args[19] == word.data_ptr()
    assert host_lib.rt_host_bounce_rows(*args) == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, wavefront.pack_rows(state))


@pytest.mark.parametrize("name", list(SCENE_TEXT))
def test_host_kernel_matches_jax_process_rays(host_lib, scenes, name):
    """One bounce (bounce 1, after a plain bounce 0) through JAX's
    process_rays and through the port's closest hit + the host kernel."""
    js, ts = scenes[name]
    seed, bnc = 9, 1
    rays = ts.num_pixels * SIZE["rays_per_pixel"]
    ids = np.arange(rays, dtype=np.int32)
    tstate = wavefront.make_initial_state(ts, torch.from_numpy(ids), 4, seed)
    tstate, _ = wavefront.process_rays(ts, tstate, seed, 0)
    jstate = jwavefront.RayState(*(jnp.asarray(leaf.numpy()) for leaf in tstate))
    jnext, _ = jwavefront.process_rays(js, jstate, seed, bnc)
    jalive = jnp.any(jstate.transmitted != 0.0, axis=-1)
    jt, jhit, _ = jwavefront.closest_hit(js, jstate.origin, jstate.direction, jalive)
    _, t, hit_index, _ = wavefront.closest_hit_of(ts, tstate, bnc)
    same_hit = hit_index.numpy() == np.asarray(jhit)
    assert same_hit.mean() >= AGREE_MIN
    tri = same_hit & (hit_index.numpy() >= ts.sphere_count)
    sphere = same_hit & (hit_index.numpy() >= 0) & ~tri
    np.testing.assert_allclose(t.numpy()[tri], np.asarray(jt)[tri], rtol=1e-4)
    # The sphere quadratic's cancellation magnifies the FMA ulps near
    # grazing hits: sphere distances are held to the state's gate.
    np.testing.assert_allclose(t.numpy()[sphere], np.asarray(jt)[sphere], rtol=1e-4,
                               atol=AGREE_TOL)
    got = host_bounce(host_lib, ts, tstate, t, hit_index, seed, bnc)
    ref = wavefront.RayState(*(torch.from_numpy(np.array(leaf)) for leaf in jnext))
    assert torch.equal(got.ray_id, ref.ray_id)
    assert_states_agree(got, ref, rows=same_hit)


def test_wrapper_runs_plain_on_cpu_and_checks_inputs(scenes):
    _, scene = scenes["torus"]
    state = wavefront.make_initial_state(scene, torch.arange(256, dtype=torch.int32), 4, 1)
    _, t, hit_index, _ = wavefront.closest_hit_of(scene, state, 0)
    launches = bounce.LAUNCHES
    got = wavefront.pack_rows(state)
    bounce.shade_rows(scene, got, t, hit_index, 1, 0)
    ref = bounce.plain_shade_bounce(scene, state, t, hit_index, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(wavefront.unpack_rows(got), ref))
    assert bounce.LAUNCHES == launches  # CPU tensors never launch
    with pytest.raises(ValueError, match="hit_index"):
        bounce.shade_rows(scene, got, t, hit_index.long(), 1, 0)
    with pytest.raises(ValueError, match="rows"):
        bounce.shade_rows(scene, got.double(), t, hit_index, 1, 0)


def test_material_table_built_once_and_rebuilt_after_update(scenes):
    _, scene = scenes["glass_torus"]
    table = bounce.material_table(scene)
    assert table.shape == (scene.materials.roughness.shape[0], bounce.MAT_WORDS)
    assert bounce.material_table(scene.with_config(width=8)) is table
    assert torch.equal(table[:, 11], scene.materials.index_of_refraction)
    mats = scene.materials
    roughness = mats.roughness.clone()
    scene2 = scene.replace(materials=mats.__class__(**{
        **{f: getattr(mats, f) for f in bounce.MATERIAL_FIELDS}, "roughness": roughness}))
    assert bounce.material_table(scene2) is not table
    with torch.no_grad():
        roughness += 0.25  # in place, as an optimizer step updates a leaf
    updated = bounce.material_table(scene2)
    assert torch.equal(updated[:, 10], roughness)
