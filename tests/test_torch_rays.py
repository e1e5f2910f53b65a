"""The forward mesh bounce's row kernels and the redesigned cull, as host builds, against their plain versions and JAX.

``csrc/rays.cu`` (set-up, sort keys, draws), ``csrc/bounce.cu`` (the packed
bounce) and ``csrc/cull.cu`` run only on the GPU, where ``chip_smoke.py``
holds them against their plain versions. Their per-ray and per-block bodies
are ``csrc/rays.cuh``, ``csrc/shading.cuh`` and ``csrc/packet.cuh``, which
``csrc/bounce_host.cpp`` and ``csrc/packet_host.cpp`` run on the host; this
file builds those two with the host C++ compiler (``-ffp-contract=off``, like
the GPU build's ``-fmad=false``) and holds, on seeded inputs:

- ``rays_setup`` (alive bit, sphere hit, ray tiles) BIT-EQUAL to
  ``intersect_spheres`` + ``make_od8`` with torch.sqrt correctly rounded, as
  on the card (this build's CPU torch.sqrt is not), and its sphere hit to
  JAX's
  ``render/wavefront.py`` ``closest_hit`` on a sphere scene (indices equal,
  distances within rtol 1e-4 / atol 1e-3: JAX's CPU floats carry FMA
  contraction, which the quadratic's cancellation on the 10,000-radius
  ground sphere magnifies);
- ``ray_keys`` and the live count BIT-EQUAL to ``morton.ray_sort_keys`` (dead
  rays, count buckets, chunk offsets) and the keys EQUAL to JAX
  ``ops/morton.py`` ``ray_sort_keys``;
- ``pcg_draws`` BIT-EQUAL to ``rng.uniforms`` and to JAX ``ops/rng.py``
  ``uniforms``, seeded as a bounce's shading (``rays.bounce_seeds``)
  and as the camera's jitter (``camera.initial_ray_seeds``);
- ``camera_rows`` (a block's packed starting rows) BIT-EQUAL to
  ``plain_camera_rows`` with torch.sqrt correctly rounded, on the torus's
  and Cornell's cameras at widths 13 and 64, 1, 4 and 20 rays a pixel,
  first rays 0 and off a block's multiple, pass seeds 0, 19 and 2^31 + 5;
  ``plain_camera_rows`` BIT-EQUAL to ``pack_rows(make_initial_state(...))``
  and to JAX ``render/wavefront.py`` ``make_initial_state`` and
  ``ops/camera.py`` ``generate_rays`` (origin, weights and ids exact, the
  direction within 1e-6: JAX's CPU floats carry FMA contraction);
- ``reorder_rows`` (the reorder's row move) BIT-EQUAL to its plain version,
  ``torch.index_select`` of the prefix and the settled suffix's slice copy,
  on rows of arbitrary bits (NaN patterns among them): random and identity
  permutations, int64 and int32, prefixes of 0, 1, 7 and 4,097 rows with and
  without a suffix, the rows past it untouched; its wrapper's input checks;
  and, with its kernel path run through the host build, a packed trace's
  bits equal to the plain path's, ``reorder.rows`` the settled rows of its
  sorted bounces there and 0 on the plain path;
- the packed bounce's fold of the packet kernel's raw hit BIT-EQUAL to the
  bounce on ``packet_intersect._finalize``'s hit (the body against the torch
  shading and JAX's ``process_rays`` is ``tests/test_torch_bounce.py``);
- the redesigned cull (flat, and gated through the same body) EQUAL to
  ``plain_cull`` (0 mismatched entry and mask elements) and BIT-EQUAL to the
  entries of ``csrc/packet.cuh``'s tie rule on edge rays: axis-parallel
  directions (inverse ±1e30, signed zeros), origins on box faces, window -1,
  NaN boxes and a box whose corners are out of order (torch's minimum leaves the sign of a ±0 tie unspecified, so the
  sign of a zero entry is held to the header's rule);

and end to end, the packed forward trace (``packed.trace_packed``) gives
the ``RayState`` trace's bits (``trace_rays``, the path every forward
render took before) on the small torus (every packet engine, the live
schedule) and on Cornell; the pass loop's blocks, traced from the camera
rows (``packed.trace_camera``), give the framebuffer's bits of blocks
traced from ``make_initial_state``; ``tests/test_torch_mesh_render.py``
holds its renders, packed now, to the JAX package's.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops import camera as jcamera
from cuda_raytracer_tpu.ops import morton as jmorton
from cuda_raytracer_tpu.ops import rng as jrng
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops import camera, packet_intersect, rng
from cuda_raytracer_tpu_torch.ops.kernels import bounce, build, cull, rays, shade
from cuda_raytracer_tpu_torch.ops.traverse import _safe_inv_dir
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

from test_torch_cuda_graphs import settled_rows
from test_torch_packet import build_mesh_both

SIZE = dict(width=16, height=16, rays_per_pixel=4, bounces=5)
AGREE_TOL = 1e-3


def _compile(tmp_path_factory, source: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = tmp_path_factory.mktemp("host") / f"lib{source}.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib_path), str(build.CSRC_DIR / f"{source}.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = _compile(tmp_path_factory, "bounce_host")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.rt_host_rays_setup.argtypes = [p, i, i, i, p, p, i, p, p, p, p, p, p]
    lib.rt_host_ray_keys.argtypes = [p, i, p, p, i, i, p, p, p]
    lib.rt_host_pcg_draws.argtypes = [p, i, u, u, i, p]
    lib.rt_host_camera_rows.argtypes = [p, i, i, i, i, u, p]
    lib.rt_host_reorder_rows.argtypes = [p, p, i, i, i, p]
    lib.rt_host_bounce_rows.argtypes = (
        [p, i, p, p, p, p] + [p, i, p, p, i, i, p, i, p, p, i, i] + [u, p, u, p, p])
    return lib


@pytest.fixture(scope="module")
def packet_host(tmp_path_factory):
    lib = _compile(tmp_path_factory, "packet_host")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_host_cull_tiles.argtypes = [p] * 4 + [i] * 3
    lib.rt_host_cull_tiles_gated.argtypes = [p] * 4 + [i] + [p] * 2 + [i] * 3
    return lib


@pytest.fixture(scope="module")
def spheres():
    return build_mesh_both(builtin_scenes.SPHERES, SIZE)


@pytest.fixture(scope="module")
def boxes():
    """A torus cut into more than 512 clusters of <= 16 triangles: two spans
    of the flat cull's grid, five gate chunks."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    scene = scene_dsl.assemble_scene(parsed, config_overrides=dict(width=8, height=8),
                                     prefer_native_bvh=False, cluster_tris=16, device="cpu")
    assert scene.num_clusters > 4 * cull.GATE_CHUNK
    return scene


@pytest.fixture(scope="module")
def torus():
    return build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL), SIZE, sky=True)


def _state(n: int, seed: int, dead_every: int = 5) -> wavefront.RayState:
    """Seeded rays around the scene: origins in [-3, 3]^3 (y in [0.1, 2.5]),
    unit directions, every ``dead_every``-th ray dead, ids not in row order."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    origin[:, 1] = rng.uniform(0.1, 2.5, n)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    transmitted = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    transmitted[::dead_every] = 0.0
    collected = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    ids = rng.permutation(n).astype(np.int32) * 3 + 11
    return wavefront.RayState(*(torch.from_numpy(a) for a in
                                (origin, direction, transmitted, collected, ids)))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.fixture(scope="module")
def cameras():
    """The small torus's camera (the torus's camera lines, whatever its
    mesh size) at 13×9 pixels and Cornell's at 64×64, both packages."""
    return {"torus": build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                                     dict(width=13, height=9)),
            "cornell": build_mesh_both(builtin_scenes.CORNELL, dict(width=64, height=64))}


def _ieee_sqrt(monkeypatch):
    """torch.sqrt correctly rounded, as on the card: a float32 square root
    taken in float64 and rounded once."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _ieee_setup(monkeypatch, rows, scene, tile):
    """``plain_rays_setup`` with torch.sqrt correctly rounded, as it is on the
    card: this build's torch.sqrt is a vectorised approximation (it gives
    sqrt(204394.015625) one ulp low, which the sphere quadratic's
    cancellation turns into thousands of ulps of t). A float32 square root
    taken in float64 and rounded once is correctly rounded."""
    sqrt = torch.sqrt
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
        return rays.plain_rays_setup(rows, scene.sphere_center, scene.sphere_radius, tile)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


# ---- rays_setup -----------------------------------------------------------


@pytest.mark.parametrize("tile", [64, 0])
def test_rays_setup_tail_counter(host, spheres, tile):
    """A second counter (``rays.live_tail``) gets the live rows the first
    one gets, in the host build and the plain version, and the outputs keep
    their bits."""
    _, ts = spheres
    rows = wavefront.pack_rows(_state(700, seed=3))
    bare = rays.setup_outputs(rows, tile)
    assert host.rt_host_rays_setup(
        *rays.setup_args(rows, ts.sphere_center, ts.sphere_radius, tile, *bare)) == 0
    got = rays.setup_outputs(rows, tile)
    live, tail = torch.zeros(1, dtype=torch.int64), torch.full((1,), 5, dtype=torch.int64)
    assert host.rt_host_rays_setup(
        *rays.setup_args(rows, ts.sphere_center, ts.sphere_radius, tile, *got, live, tail)) == 0
    _assert_bit_equal(got[:3] + got[3:] * bool(tile), bare[:3] + bare[3:] * bool(tile))
    plain_live, plain_tail = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    rays.plain_rays_setup(rows, ts.sphere_center, ts.sphere_radius, tile, plain_live, plain_tail)
    assert int(live) == int(tail) - 5 == int(plain_live) == int(plain_tail) == int(bare[0].sum())
    assert 0 < int(live) < 700
    with pytest.raises(ValueError, match="tail needs live"):
        rays.rays_setup(rows, ts.sphere_center, ts.sphere_radius, tile, None, plain_tail)


@pytest.mark.parametrize("n,tile", [(1000, 64), (333, 32), (250, 0)])
def test_rays_setup_host_bit_equal_plain_and_jax(host, spheres, monkeypatch, n, tile):
    js, ts = spheres
    state = _state(n, seed=n)
    rows = wavefront.pack_rows(state)
    want = _ieee_setup(monkeypatch, rows, ts, tile)
    got = rays.setup_outputs(rows, tile)
    live = torch.zeros(1, dtype=torch.int64)
    assert host.rt_host_rays_setup(
        *rays.setup_args(rows, ts.sphere_center, ts.sphere_radius, tile, *got, live)) == 0
    assert int(live) == int(want[0].sum())  # the live counter: padding rays are dead
    assert (got[3] is None) == (tile == 0)
    if tile:
        assert got[3].shape == (-(-n // tile), 8, tile)
    _assert_bit_equal(got[:3] + got[3:] * bool(tile), want[:3] + want[3:] * bool(tile))
    plain = rays.plain_rays_setup(rows, ts.sphere_center, ts.sphere_radius, tile)
    assert torch.equal(plain[2], want[2])
    np.testing.assert_allclose(plain[1].numpy(), want[1].numpy(), rtol=1e-4, atol=AGREE_TOL)
    alive, t, index = want[:3]
    assert (~alive).any() and (index >= 0).any() and (alive & (index < 0)).any()
    # JAX's closest hit on the sphere scene (no triangles): its sphere part.
    jt, jindex, _ = jwavefront.closest_hit(js, jnp.asarray(state.origin.numpy()),
                                           jnp.asarray(state.direction.numpy()),
                                           jnp.asarray(alive.numpy()))
    assert np.array_equal(np.asarray(jindex), index.numpy())
    np.testing.assert_allclose(np.asarray(jt), t.numpy(), rtol=1e-4, atol=AGREE_TOL)


# ---- ray_keys ---------------------------------------------------------------


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("chunk", [1000, 96])
def test_ray_keys_host_bit_equal_plain_and_jax(host, torus, count, chunk):
    js, ts = torus
    n = 1000
    state = _state(n, seed=3)
    rows = wavefront.pack_rows(state)
    want_keys, want_live = rays.plain_ray_keys(rows, ts.min_coord, ts.inv_extent, count, chunk)
    keys = torch.empty(n, dtype=torch.int64)
    live = torch.empty(1, dtype=torch.int32)
    assert host.rt_host_ray_keys(
        *rays.keys_args(rows, ts.min_coord, ts.inv_extent, count, chunk, keys, live)) == 0
    assert torch.equal(keys, want_keys) and torch.equal(live, want_live)
    alive = np.any(state.transmitted.numpy() != 0, axis=1)
    assert int(live) == alive.sum() < n
    jkeys = np.asarray(jmorton.ray_sort_keys(
        jnp.asarray(state.origin.numpy()), jnp.asarray(state.direction.numpy()),
        jnp.asarray(alive), js.min_coord, js.inv_extent)).astype(np.int64) & 0xFFFFFFFF
    if count:
        jkeys = np.where(alive, np.minimum(jkeys >> rays.COUNT_BUCKET_SHIFT, 254), 255)
    assert np.array_equal(keys.numpy() & 0xFFFFFFFF, jkeys)
    assert np.array_equal(keys.numpy() >> 32, np.arange(n) // chunk)
    # One flat stable sort is the per-chunk stable sort: dead rays last in
    # every chunk, no ray leaves its chunk.
    order = torch.argsort(keys, stable=True).numpy()
    assert np.array_equal(order // chunk, np.arange(n) // chunk)
    for lo in range(0, n, chunk):
        per_chunk = lo + np.argsort(jkeys[lo:lo + chunk], kind="stable")
        assert np.array_equal(order[lo:lo + chunk], per_chunk)


# ---- pcg_draws ----------------------------------------------------------------


@pytest.mark.parametrize("pass_seed,bnc", [(0, 0), (19, 3), (77, 9)])
def test_pcg_draws_host_bit_equal_plain_and_jax(host, pass_seed, bnc):
    """The draws of a bounce's shading and of the camera's jitter."""
    ids = np.random.default_rng(pass_seed).integers(0, 2**31 - 1, 4096).astype(np.int32)
    ids[:2] = (0, 2**31 - 1)
    tids = torch.from_numpy(ids)
    seedings = {
        "bounce": (rays.BOUNCE_RAY_MULT, rays.bounce_seed_add(pass_seed, bnc), 5,
                   jwavefront.bounce_seeds(jnp.asarray(ids), pass_seed, bnc)),
        "camera": (camera.RAY_SEED_MULT, camera._seed_add(pass_seed), 2,
                   jcamera.initial_ray_seeds(jnp.asarray(ids), pass_seed)),
    }
    for mult, add, n, jseeds in seedings.values():
        want = rays.plain_pcg_draws(tids, mult, add, n)
        got = torch.empty((n, ids.shape[0]), dtype=torch.int64)
        assert host.rt_host_pcg_draws(*rays.draws_args(tids, mult, add, n, got)) == 0
        assert torch.equal(got, want)
        jwant = np.asarray(jrng.uniforms(jseeds, n)).astype(np.int64)
        assert np.array_equal(jwant, want.numpy())
    assert torch.equal(rays.plain_bounce_draws(tids, pass_seed, bnc),
                       rng.uniforms(rays.bounce_seeds(tids, pass_seed, bnc), 5))
    launches = rays.LAUNCHES_DRAWS
    assert torch.equal(rays.bounce_draws(tids, pass_seed, bnc),
                       rays.plain_bounce_draws(tids, pass_seed, bnc))
    assert rays.LAUNCHES_DRAWS == launches  # CPU tensors never launch
    with pytest.raises(ValueError, match="ray_id"):
        rays.bounce_draws(tids.long(), pass_seed, bnc)


# ---- camera_rows ----------------------------------------------------------------


@pytest.mark.parametrize("name,ray_lo,rpp,seed", [
    ("torus", 0, 1, 0), ("torus", 77, 4, 19), ("torus", 5, 20, 2**31 + 5),
    ("cornell", 0, 20, 19), ("cornell", 4100, 4, 2**31 + 5), ("cornell", 1237, 1, 0)])
def test_camera_rows_host_bit_equal_plain_and_jax(host, cameras, monkeypatch, name, ray_lo,
                                                  rpp, seed):
    """The camera kernel's body against its plain version (and that against
    the sequence it replaces and JAX), on up to 2,048 rows of a pass."""
    js, ts = cameras[name]
    width = ts.config.width
    n = min(ts.num_pixels * rpp - ray_lo, 2048)
    words = rays.camera_words(ts.camera)
    assert rays.camera_words(ts.camera) is words  # built once per camera
    ids = ray_lo + torch.arange(n, dtype=torch.int32)
    plain = rays.plain_camera_rows(words, ray_lo, n, rpp, width, seed)
    before = rays.LAUNCHES_CAMERA
    _assert_bit_equal((rays.camera_rows(words, ray_lo, n, rpp, width, seed),), (plain,))
    assert rays.LAUNCHES_CAMERA == before  # CPU tensors never launch
    _assert_bit_equal((plain,), (wavefront.pack_rows(
        wavefront.make_initial_state(ts, ids, rpp, seed)),))
    assert torch.equal(plain[:, 12].view(torch.int32), ids)
    assert not plain[:, 13:].any()
    jstate = jwavefront.make_initial_state(js, jnp.asarray(ids.numpy()), rpp, seed)
    jorigin, jdirection = jcamera.generate_rays(js.camera, width, rpp,
                                                jnp.asarray(ids.numpy()), seed)
    state = wavefront.unpack_rows(plain)
    for got, want in ((state.origin, jorigin), (state.origin, jstate.origin),
                      (state.transmitted, jstate.transmitted),
                      (state.collected, jstate.collected), (state.ray_id, jstate.ray_id)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for want in (jdirection, jstate.direction):
        np.testing.assert_allclose(state.direction.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    _ieee_sqrt(monkeypatch)
    want = rays.plain_camera_rows(words, ray_lo, n, rpp, width, seed)
    got = torch.empty((n, rays.ROW_WORDS), dtype=torch.float32)
    assert host.rt_host_camera_rows(*rays.camera_args(words, ray_lo, n, rpp, width, seed,
                                                      got)) == 0
    _assert_bit_equal((got,), (want,))


def test_camera_rows_check_inputs(cameras):
    words = rays.camera_words(cameras["torus"][1].camera)
    with pytest.raises(ValueError, match="camera words"):
        rays.camera_rows(words[:12], 0, 16, 4, 13, 0)
    with pytest.raises(ValueError, match="camera words"):
        rays.camera_rows(words.double(), 0, 16, 4, 13, 0)
    with pytest.raises(ValueError, match="camera rows"):
        rays.camera_rows(words, 2**31 - 8, 16, 4, 13, 0)
    assert rays.camera_rows(words, 3, 0, 4, 13, 0).shape == (0, rays.ROW_WORDS)


def test_row_wrappers_run_plain_on_cpu_and_check_inputs(torus):
    _, ts = torus
    rows = wavefront.pack_rows(_state(300, seed=1))
    before = (rays.LAUNCHES_SETUP, rays.LAUNCHES_KEYS)
    _assert_bit_equal(rays.rays_setup(rows, ts.sphere_center, ts.sphere_radius, 64),
                      rays.plain_rays_setup(rows, ts.sphere_center, ts.sphere_radius, 64))
    _assert_bit_equal(rays.ray_keys(rows, ts.min_coord, ts.inv_extent, True, 300),
                      rays.plain_ray_keys(rows, ts.min_coord, ts.inv_extent, True, 300))
    assert (rays.LAUNCHES_SETUP, rays.LAUNCHES_KEYS) == before
    with pytest.raises(ValueError, match="rows"):
        rays.rays_setup(rows[:, :12], ts.sphere_center, ts.sphere_radius, 64)
    with pytest.raises(ValueError, match="rows"):
        rays.ray_keys(rows[::2], ts.min_coord, ts.inv_extent, True, 300)


# ---- reorder_rows ---------------------------------------------------------------

SENTINEL = -7.0  # the spare buffer's rows before a move


def _move_case(n: int, extra: int, perm: str, index: torch.dtype, seed: int = 2):
    """(cur, order, settled, spare) of a row move: ``cur`` holds arbitrary
    32-bit patterns (NaNs among them) and 4 rows past the settled ones,
    ``spare`` SENTINEL rows, 6 past them."""
    g = torch.Generator().manual_seed(seed + n + extra)
    settled = n + extra
    cur = torch.randint(-2**31, 2**31 - 1, (settled + 4, rays.ROW_WORDS), generator=g,
                        dtype=torch.int32).view(torch.float32)
    order = torch.randperm(n, generator=g) if perm == "random" else torch.arange(n)
    spare = torch.full((settled + 6, rays.ROW_WORDS), SENTINEL)
    return cur, order.to(index), settled, spare


@pytest.mark.parametrize("index", [torch.int64, torch.int32])
@pytest.mark.parametrize("perm", ["random", "identity"])
@pytest.mark.parametrize("n", [0, 1, 7, 4097])
@pytest.mark.parametrize("extra", [0, 5])
def test_reorder_rows_host_bit_equal_plain(host, index, perm, n, extra):
    cur, order, settled, spare = _move_case(n, extra, perm, index)
    want = rays.plain_reorder_rows(cur, order, n, settled, spare.clone())
    got = spare.clone()
    assert host.rt_host_reorder_rows(*rays.reorder_args(cur, order, n, settled, got)) == 0
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(want[:n]), _bits(cur[order.long()]))
    assert torch.equal(_bits(want[n:settled]), _bits(cur[n:settled]))
    assert (want[settled:] == SENTINEL).all()
    before = rays.LAUNCHES_REORDER
    assert torch.equal(_bits(rays.reorder_rows(cur, order, n, settled, spare.clone())),
                       _bits(want))
    assert rays.LAUNCHES_REORDER == before


def test_reorder_rows_checks_inputs(host):
    cur, order, settled, spare = _move_case(7, 5, "random", torch.int64)
    assert host.rt_host_reorder_rows(cur.data_ptr(), order.data_ptr(), 2, 7, settled,
                                     spare.data_ptr()) != 0
    bad = {
        "rows": (cur[:, :12], order, 7, settled, spare),
        "contiguous": (cur, order, 7, settled, spare[:, :].t().contiguous().t()),
        "int64 or int32": (cur, order.to(torch.int16), 7, settled, spare),
        "(7,)": (cur, order[:6], 7, settled, spare),
        "contiguous (7,)": (cur, torch.arange(14)[::2], 7, settled, spare),
        "settled": (cur, order, 7, 6, spare),
        "the rows of both": (cur, order, 7, cur.shape[0] + 1, spare),
        "overlap": (cur, order, 7, settled, cur),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=re.escape(match)):
            rays.reorder_rows(*args)
    with pytest.raises(ValueError, match="overlap"):
        rays.reorder_rows(spare[3:], order, 7, settled, spare)


@pytest.fixture
def host_move(host, monkeypatch):
    """``rays.reorder_rows``' kernel path on CPU tensors, its launch run by
    the host build: every other wrapper keeps its CPU path."""
    kind = rays.device_kind

    def launch(*args):
        return host.rt_host_reorder_rows(*args[:-1])

    monkeypatch.setattr(rays, "device_kind",
                        lambda x, name: "cuda" if name == "reorder_rows" else kind(x, name))
    monkeypatch.setattr(rays, "library",
                        lambda: types.SimpleNamespace(lib=types.SimpleNamespace(
                            rt_reorder_rows=launch)))
    monkeypatch.setattr(rays, "_stream", lambda x: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())


@pytest.mark.parametrize("schedule", [(), (1, 64)])
def test_reorder_rows_kernel_path_in_a_trace(torus, host_move, schedule):
    """A packed trace through the row move's kernel path (the host build)
    gives the plain path's bits; ``reorder.rows`` counts the settled rows of
    each sorted bounce there, one launch each, and nothing on the plain
    path."""
    _, ts = torus
    scene = ts.with_config(packet_backend="fused1", live_schedule=schedule)
    ids = torch.arange(512, dtype=torch.int32)
    state = wavefront.make_initial_state(scene, ids, SIZE["rays_per_pixel"], 6)
    traces = {}
    for plain in (False, True):
        m, bounds, before = metrics.Metrics(), [], rays.LAUNCHES_REORDER
        with metrics.attached(m):
            out, suspect = packed.trace_packed(scene, state, 6, 5, True, plain=plain,
                                               bounds=bounds)
        traces[plain] = (out, suspect, bounds, m.resolve().counters,
                         rays.LAUNCHES_REORDER - before)
    (got, got_suspect, bounds, counters, launches), want = traces[False], traces[True]
    _assert_bit_equal(got, want[0])
    assert got_suspect == want[1] and bounds == want[2]
    sorted_bounces = sum(wavefront.bounce_schedule(scene, 512, 5, True).sorted)
    assert launches == sorted_bounces > 0 and want[4] == 0
    assert counters["reorder.rows"] == settled_rows(scene, 512, 5, bounds) > 0
    assert "reorder.rows" not in want[3]


# ---- the packed bounce's fold -----------------------------------------------


def test_host_bounce_folds_the_packet_hit(host, torus):
    """The bounce kernel given the set-up kernel's sphere hit and fused1's raw
    triangle hit writes the bits it writes given the finalised closest hit;
    dead rows and the ray-id column are untouched; the torch shading agrees
    to the shade gate."""
    _, ts = torus
    ts = ts.with_config(packet_backend="fused1")
    n, tile, seed, bnc = 1500, ts.config.packet_tile, 4, 1
    state = wavefront.make_initial_state(ts, torch.arange(n, dtype=torch.int32), 4, seed)
    state, _ = wavefront.process_rays(ts, state, seed, 0)
    rows = wavefront.pack_rows(state)
    alive, t, index, od8 = rays.plain_rays_setup(rows, ts.sphere_center, ts.sphere_radius, tile)
    t_tri, tri = packet_intersect.packet_tiles(ts, od8, "fused1")
    t_fin, i_fin, _ = packet_intersect._finalize(ts, t_tri, tri, None, t, index, n, tile)
    assert (~alive).any() and (alive & (i_fin >= 0)).any() and (alive & (i_fin < 0)).any()
    folded, finalised = rows.clone(), rows.clone()
    assert host.rt_host_bounce_rows(
        *bounce.kernel_args(ts, folded, t, index, seed, bnc, t_tri, tri)) == 0
    assert host.rt_host_bounce_rows(
        *bounce.kernel_args(ts, finalised, t_fin, i_fin, seed, bnc)) == 0
    assert torch.equal(_bits(folded), _bits(finalised))
    assert torch.equal(_bits(folded[~alive]), _bits(rows[~alive]))
    assert torch.equal(_bits(folded[:, 12:]), _bits(rows[:, 12:]))
    plain = rows.clone()
    bounce.plain_shade_rows(ts, plain, t, index, seed, bnc, t_tri, tri)
    diff = (folded[:, :12] - plain[:, :12]).abs().amax(dim=1)
    assert torch.isfinite(folded).all() and (diff < AGREE_TOL).float().mean() >= 0.999


# ---- the redesigned cull on edge rays ------------------------------------------


def _edge_od8(scene, tile: int, seed: int = 5):
    """Ray tiles that hit the slab test's edges: origins inside a box with one
    coordinate on a face (or on a corner), axis-parallel directions (some
    with -0 components, so the safe inverse is ±1e30) and random ones, open,
    finite and -1 windows. A ray leaving a box through the face its origin
    lies on has entry -0 in the plain rule, one entering it +0."""
    rng = np.random.default_rng(seed)
    cmin, cmax = scene.cluster_min.numpy(), scene.cluster_max.numpy()
    K = cmin.shape[0]
    n = 8 * tile + 13
    k = rng.integers(0, K, n)
    origin = (cmin[k] + rng.uniform(0.1, 0.9, (n, 3)) * (cmax[k] - cmin[k])).astype(np.float32)
    face = rng.integers(0, 3, n)
    rows = np.arange(n)
    origin[rows, face] = np.where(rng.random(n) < 0.5, cmin[k, face], cmax[k, face])
    corner = rows % 7 == 0
    origin[corner] = cmin[k[corner]]
    axes = np.eye(3, dtype=np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    parallel = rows % 2 == 0
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    direction[parallel] = axes[face][parallel] * sign[parallel, None]
    negzero = parallel & (rows % 4 == 0)
    direction[negzero] = np.where(direction[negzero] == 0, np.float32(-0.0), direction[negzero])
    window = np.full(n, 1e30, np.float32)
    window[rows % 5 == 1] = rng.uniform(0.0, 2.0, (rows % 5 == 1).sum())
    window[rows % 11 == 3] = -1.0
    padded = packet_intersect._pad_rays(*(torch.from_numpy(a) for a in
                                          (origin, direction, window)), tile)
    return cull.make_od8(*padded, tile)


def _min_nan(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.where(b < a, b, a)))


def _max_nan(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.where(a < b, b, a)))


def _rule_cull(od8: torch.Tensor, aabb: torch.Tensor) -> np.ndarray:
    """The cull's entries under packet.cuh's own rule, in numpy: the slab
    test's min / max with NaN winning and the first operand winning ties, the
    tile's minimum folded over its rays in order (an earlier ray's entry wins
    a tie). It fixes the sign of a zero entry, which plain_cull's
    torch.minimum / amin leave to their implementation."""
    T, _, tile = od8.shape
    o = od8[:, 0:3].permute(0, 2, 1).reshape(-1, 1, 3).numpy()
    inv = _safe_inv_dir(od8[:, 3:6].permute(0, 2, 1).reshape(-1, 3)).numpy()[:, None]
    win = od8[:, 6].reshape(-1, 1).numpy()
    lo, hi = aabb[0:3].T.numpy()[None], aabb[3:6].T.numpy()[None]
    with np.errstate(invalid="ignore", over="ignore"):
        tmin = np.zeros((o.shape[0], lo.shape[1]), np.float32)
        tmax = np.broadcast_to(win, tmin.shape)
        for a in range(3):
            t1 = (lo[..., a] - o[..., a]) * inv[..., a]
            t2 = (hi[..., a] - o[..., a]) * inv[..., a]
            tmin = _min_nan(_max_nan(t1, tmin), _max_nan(t2, tmin))
            tmax = _max_nan(_min_nan(t1, tmax), _min_nan(t2, tmax))
        e = np.where(tmin <= tmax, tmin, np.float32(cull.MISS_ENTRY)).reshape(T, tile, -1)
    acc = np.full((T, e.shape[2]), cull.MISS_ENTRY, np.float32)
    for r in range(tile):
        acc = np.where(e[:, r] < acc, e[:, r], acc)
    return acc


@pytest.mark.parametrize("tile", [64, 40])
def test_cull_host_bit_equal_plain_on_edge_rays(packet_host, boxes, tile):
    """0 mismatched entry and mask elements against plain_cull, and the entry
    bits of packet.cuh's rule (``_rule_cull``), -0 entries included: the
    single-instruction min / max order -0 below +0, so the body restores the
    rule's sign of every zero entry, and this case has both signs."""
    od8 = _edge_od8(boxes, tile)
    T = od8.shape[0]
    aabb = cull.box_table(boxes.cluster_min, boxes.cluster_max)
    aabb[:, 3] = float("nan")  # NaN boxes: every component, or one
    aabb[4, 7] = float("nan")
    aabb[[0, 3], 11] = aabb[[3, 0], 11]  # corners out of order on x
    K = aabb.shape[1]
    want_entry, want_mask = cull.plain_cull(od8, aabb, with_mask=True)
    rule = torch.from_numpy(_rule_cull(od8, aabb))
    zero = rule == 0
    assert (zero & (rule.view(torch.int32) != 0)).any() and (rule.view(torch.int32) == 0).any()
    assert (want_entry < cull.MISS_ENTRY).any() and (want_mask != 0).any()
    entry, mask = torch.empty_like(want_entry), torch.empty_like(want_mask)
    packet_host.rt_host_cull_tiles(od8.data_ptr(), aabb.data_ptr(), entry.data_ptr(),
                                   mask.data_ptr(), T, K, tile)
    assert torch.equal(entry, want_entry) and torch.equal(mask, want_mask)
    assert torch.equal(_bits(entry), _bits(rule))
    # The gated cull, all gates open, over the table padded to whole chunks.
    Kp = -(-K // cull.GATE_CHUNK) * cull.GATE_CHUNK
    far = torch.full((8, Kp - K), 1e17)
    far[6:] = 0.0
    aabb_p = torch.cat([aabb, far], dim=1).contiguous()
    gates = torch.full((T * cull.gate_words(Kp // cull.GATE_CHUNK),), -1, dtype=torch.int32)
    entry_g = torch.empty((T, Kp))
    mask_g = torch.empty((T, want_mask.shape[1], Kp), dtype=torch.int32)
    packet_host.rt_host_cull_tiles_gated(od8.data_ptr(), aabb_p.data_ptr(), gates.data_ptr(),
                                         None, 0, entry_g.data_ptr(), mask_g.data_ptr(), T,
                                         Kp, tile)
    assert torch.equal(_bits(entry_g[:, :K]), _bits(entry))
    assert torch.equal(mask_g[:, :, :K], want_mask)


# ---- the packed forward trace, end to end ---------------------------------------


def _traces(scene, n: int = 512, seed: int = 6, bounces: int = 5):
    """``trace_packed`` and ``trace_rays`` of one forward wavefront → the two
    (state, suspect) results."""
    ids = torch.arange(n, dtype=torch.int32)
    state = wavefront.make_initial_state(scene, ids, SIZE["rays_per_pixel"], seed)
    return (packed.trace_packed(scene, state, seed, bounces, True),
            wavefront.trace_rays(scene, state, seed, bounces, True))


@pytest.mark.parametrize("backend,chunks", [
    pytest.param("auto", 1, id="auto"), pytest.param("fused", 1, id="fused"),
    pytest.param("fused1", 1, id="fused1"), pytest.param("pallas", 1, id="pallas"),
    pytest.param("auto", 2, id="auto-two-chunks")])
def test_packed_trace_gives_the_ray_state_bits(torus, monkeypatch, backend, chunks):
    """Every packet engine: the set-up kernel's ray tiles for fused and fused1
    (fused with its skip test), triangle_hit for the xla ("auto" on the CPU)
    and pallas engines. With the wavefront two sort chunks (``SORT_CHUNK``
    below it) neither trace compacts: every bounce runs all the rows, and
    the reorder is chunk-local."""
    _, ts = torus
    scene = ts.with_config(packet_backend=backend, packet_skip=backend == "fused")
    n = 512
    if chunks > 1:
        monkeypatch.setattr(wavefront, "SORT_CHUNK", 4096)
        n = 4096 * chunks
        scene = scene.with_config(width=64, height=n // (64 * SIZE["rays_per_pixel"]))
        schedule = wavefront.bounce_schedule(scene, n, 5, True)
        assert schedule.chunk == 4096 and any(schedule.sorted) and not schedule.compact
    (got, got_suspect), (want, want_suspect) = _traces(scene, n)
    _assert_bit_equal(got, want)
    assert got_suspect == want_suspect == 0
    assert not torch.equal(got.ray_id, want.ray_id.sort().values)  # it was sorted


def test_packed_render_gives_the_ray_state_framebuffer(torus, monkeypatch):
    """The pass loop's framebuffer, bit for bit, on the small torus and on
    Cornell (brute intersector), against its blocks traced on the
    ``RayState`` (``make_initial_state``, ``trace_rays``).
    tests/test_torch_mesh_render.py holds the same renders, packed since
    they trace forward, to the JAX package."""
    _, ts = torus
    cornell = build_mesh_both(builtin_scenes.CORNELL, dict(SIZE, width=8, height=8))[1]
    scenes = (ts.with_config(width=8, height=8), cornell)
    got = [pipeline.render_framebuffer(scene) for scene in scenes]
    monkeypatch.setattr(packed, "trace_camera", _old_trace_camera)
    monkeypatch.setattr(packed, "trace_wavefront", wavefront.trace_rays)
    for fb, scene in zip(got, scenes):
        assert torch.equal(fb, pipeline.render_framebuffer(scene))


def _old_trace_camera(scene, ray_lo, n, rpp, pass_seed, bounces, sort_rays, reparam=False,
                      checkpoint_bounces=True):
    """A block traced as the pass loop traced it before the camera kernel:
    the ids, ``make_initial_state`` and ``trace_wavefront``."""
    ids = ray_lo + torch.arange(n, dtype=torch.int32)
    state = wavefront.make_initial_state(scene, ids, rpp, pass_seed)
    return packed.trace_wavefront(scene, state, pass_seed, bounces, sort_rays,
                                  reparam=reparam, checkpoint_bounces=checkpoint_bounces)


@pytest.mark.parametrize("name", ["torus", "cornell"])
@pytest.mark.parametrize("sort_rays", [True, False])
def test_blocks_from_camera_rows_give_the_framebuffer(torus, monkeypatch, name, sort_rays):
    """The pass loop's forward blocks start from ``camera_rows`` (one call a
    block, its rows handed to ``trace_packed``) and give, bit for bit, the
    framebuffer of blocks traced from ``make_initial_state``: two blocks a
    pass (rays 0-71 and 72-143), two passes, on the small torus (packet)
    and Cornell (brute)."""
    scene = (torus[1] if name == "torus" else
             build_mesh_both(builtin_scenes.CORNELL, SIZE)[1])
    scene = scene.with_config(width=8, height=6, rays_per_pixel=6, bounces=3,
                              max_rays_per_pixel_per_pass=3, sort_rays=sort_rays)
    monkeypatch.setattr(pipeline, "RAY_BLOCK", 8 * 3 * 3)
    calls, handed = [], []
    camera_rows, trace_packed = rays.camera_rows, packed.trace_packed
    monkeypatch.setattr(rays, "camera_rows",
                        lambda *a: calls.append(a[1:]) or camera_rows(*a))
    monkeypatch.setattr(packed, "trace_packed",
                        lambda sc, state, *a, **k: handed.append(
                            isinstance(state, torch.Tensor)) or trace_packed(sc, state, *a, **k))
    got = pipeline.render_framebuffer(scene)
    assert [c[:2] for c in calls] == [(0, 72), (72, 72)] * 2 and all(handed)
    monkeypatch.setattr(packed, "trace_camera", _old_trace_camera)
    assert torch.equal(got, pipeline.render_framebuffer(scene))
    assert len(calls) == 4


def test_plain_trace_calls_no_kernel_wrapper(monkeypatch):
    """``shade.plain_trace``, the brute megakernel's plain version, traces
    with ``plain=True``: the forward trace's bits on Cornell, and no row
    kernel's wrapper called, so on the card it shares no device code with
    the kernel it checks."""
    cornell = build_mesh_both(builtin_scenes.CORNELL, dict(SIZE, width=8, height=8))[1]
    rpp = SIZE["rays_per_pixel"]
    ids = torch.arange(8 * 8 * rpp, dtype=torch.int32)
    state = wavefront.make_initial_state(cornell, ids, rpp, 4)
    want = packed.trace_wavefront(cornell, state, 4, 3, sort_rays=False)[0].collected

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for module, name in ((rays, "rays_setup"), (rays, "pcg_draws"), (rays, "ray_keys"),
                         (rays, "camera_rows"), (bounce, "shade_rows")):
        monkeypatch.setattr(module, name, refuse)
    assert torch.equal(shade.plain_trace(cornell, ids, rpp, 4, 3), want)


def test_packed_trace_schedule_keeps_the_bits(torus):
    """A static live schedule, its certificate included: the packed trace's
    state, ids and suspect count equal the RayState trace's. (Chunk-local
    sorts of a wavefront larger than the sort chunk, where no live prefix
    runs, are tests/test_torch_mesh_render.py's
    test_sort_blocks_and_chunks_do_not_change_bits, packed now.)"""
    _, ts = torus
    for schedule, suspect in (((1,), False), ((1, 64), True)):
        (got, got_suspect), (want, want_suspect) = _traces(
            ts.with_config(packet_backend="fused1", live_schedule=schedule))
        _assert_bit_equal(got, want)
        assert got_suspect == want_suspect and (want_suspect > 0) == suspect
