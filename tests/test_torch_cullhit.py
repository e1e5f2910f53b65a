"""The "cullhit" sort key, the bucket-sort destinations and the PCG wrappers of the port against the JAX package, on the CPU.

``csrc/rays.cu``'s cullhit key kernel runs only on the GPU, where
``chip_smoke.py`` (phase 13e) holds it against its plain version. Its
per-ray body is in ``csrc/rays.cuh``, which ``csrc/bounce_host.cpp`` runs
on the host; this file builds that with the host C++ compiler and holds:

- ``morton.first2_cluster_keys`` EQUAL to JAX ``ops/morton.py``'s on
  tests/test_morton.py's two cases (K across a chunk boundary with dead
  rays; K = 3000 with ``cull_split`` 2, which squeezes the ids to 11 bits)
  and on the small torus's cluster boxes;
- the host build of the key (``rt_host_cullhit_keys``: the kernel's gated
  scan, its warp vote emulated over 1, 8 and 32 rows in lockstep, the
  table staged whole or in steps) BIT-EQUAL to its plain version
  (``rays.plain_cullhit_keys``): keys and live count in both ``count``
  modes (the bucket clamp at fh >= 1024 included), chunk offsets, and its
  test counter (gates and boxes tested) against a NumPy recount of the
  gated scan; also on edge rows (subnormal direction components with box
  planes at the origin, inverted boxes, far point boxes inside K * S at
  ``cull_split`` 2, rays whose only hits lie in the last gate's group);
- each gate of ``rays.cullhit_tables`` the tight super-box of both corners
  of its members, and ``rays.flat_box_tests`` (the flat scan's tests, the
  bound's count) EQUAL to a NumPy recount;
- the small torus's framebuffer with ``sort_key`` "cullhit" and "auto"
  BIT-IDENTICAL to the Morton key's under both sort engines (any
  permutation renders the same bits), and the two keys resolving as JAX's;
- ``sort.bucket_sort_dest`` EQUAL to JAX's (dead keys, a ragged n, the
  2^24 refusal) and its inverse EQUAL to ``wavefront.sort_order``'s
  permutation on the same rows;
- ``rng.random01`` EQUAL to JAX's, ``rng.random_on_sphere``'s states EQUAL
  and its points within 1e-6 (libm sin / cos, as test_torch_primitives.py
  holds ``on_sphere_from_bits``).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops import morton as jmorton
from cuda_raytracer_tpu.ops import rng as jrng
from cuda_raytracer_tpu.ops import sort as jsort

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops import morton, rng, sort
from cuda_raytracer_tpu_torch.ops.kernels import rays
from cuda_raytracer_tpu_torch.render import pipeline, wavefront

from test_torch_packet import build_mesh_both
from test_torch_rays import _compile


def _boxes(seed, R, K, S, half_hi, far=None):
    """Rays and K * S boxes; with ``far``, box rows from ``far`` on and the
    first half of the rays moved 100 along x, so those rays' first hits
    have high ids."""
    rng_ = np.random.default_rng(seed)
    o = rng_.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = rng_.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4, 0] = 0.0  # the 1e-30 inverse
    d[4:6, 1] = -0.0
    centers = rng_.uniform(-3, 3, (K * S, 3)).astype(np.float32)
    half = rng_.uniform(0.05, half_hi, (K * S, 3)).astype(np.float32)
    alive = rng_.uniform(size=R) < 0.9
    if far is not None:
        centers[far:, 0] += 100.0
        o[:R // 2, 0] += 100.0
    return o, d, alive, centers - half, centers + half


CASES = {  # tests/test_morton.py's two cases: (seed, R, K, cull_split, box half-size),
    # and the second with high first-hit ids (count buckets clamped at fh >= 1024)
    "chunk_boundary": (7, 512, morton._FIRST2_CHUNK + 37, 1, 0.8),
    "squeezed_split": (3, 128, 3000, 2, 0.5),
    "squeezed_far": (3, 128, 3000, 2, 0.5, 4000),
}


def _rows(o, d, alive):
    rows = torch.zeros((o.shape[0], 16))
    rows[:, 0:3], rows[:, 3:6] = torch.from_numpy(o), torch.from_numpy(d)
    rows[:, 6:9] = torch.from_numpy(alive.astype(np.float32))[:, None] * 0.5
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_first2_cluster_keys_match_jax(case):
    seed, R, K, S = CASES[case][:4]
    o, d, alive, bmin, bmax = _boxes(*CASES[case])
    ref = np.asarray(jmorton.first2_cluster_keys(
        *map(jnp.asarray, (o, d, alive, bmin, bmax)), K, S))
    got = morton.first2_cluster_keys(*map(torch.from_numpy, (o, d, alive, bmin, bmax)), K, S)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    fh = got.numpy()[alive] >> 21
    assert (fh < (2047 if K + 1 > 2048 else K)).mean() > 0.3
    assert (got.numpy()[~alive] == morton.DEAD_RAY_KEY).all()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = _compile(tmp_path_factory, "bounce_host")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_host_cullhit_keys.argtypes = [p, i, p, p] + [i] * 6 + [p] * 4 + [i, i]
    return lib


def _host_keys(lib, rows, bmin, bmax, K, S, count, chunk, lanes=32, staged=0):
    """The host build's (keys, live, tests); ``staged`` 0 stages as the
    kernel does (rt::kMaxStaged boxes a step)."""
    keys = torch.empty(rows.shape[0], dtype=torch.int64)
    live = torch.empty(1, dtype=torch.int32)
    tests = torch.zeros(1, dtype=torch.int64)
    boxes, gates = rays.cullhit_tables(bmin, bmax, K * S)
    assert lib.rt_host_cullhit_keys(*rays.cullhit_args(rows, boxes, gates, S, K, count, chunk,
                                                       keys, live, None, tests),
                                    lanes, staged) == 0
    return keys, live, int(tests)


def _hits(o, d, bmin, bmax):
    """(R, rows) slab hits as first2_cluster_keys tests them, and whether
    any plane parameter is NaN."""
    with np.errstate(invalid="ignore", over="ignore"):
        inv = 1.0 / np.where(d == 0, np.float32(1e-30), d)
        t1 = (bmin[None] - o[:, None]) * inv[:, None]
        t2 = (bmax[None] - o[:, None]) * inv[:, None]
    near = np.maximum(np.minimum(t1, t2).max(axis=2), 0.0)
    far = np.maximum(t1, t2).min(axis=2)
    nan = np.isnan(t1).any(axis=2) | np.isnan(t2).any(axis=2)
    return (near <= far) & ~nan, nan


def _tests_needed(o, d, alive, bmin, bmax, K, S):
    """Boxes a ray tests in ascending order until its second distinct hit
    (all of them when it has none), summed over live rays."""
    hit, _ = _hits(o, d, bmin, bmax)
    ids = np.arange(K * S) // S
    total = 0
    for r in np.flatnonzero(alive):
        rows = np.flatnonzero(hit[r])
        second = rows[ids[rows] != ids[rows[0]]] if rows.size else rows
        total += int(second[0]) + 1 if second.size else K * S
    return total


def _gated_tests_needed(o, d, alive, bmin, bmax, K, S, G=rays.CULLHIT_GATE):
    """The gates and boxes the gated scan tests, summed over live rays: a
    ray tests each gate until it is done, and a gate's rows up to its
    second distinct hit when that gate hits (a NaN counting as a hit)."""
    hit, _ = _hits(o, d, bmin, bmax)
    n = K * S
    gates = [(np.minimum(bmin, bmax)[g:g + G].min(axis=0),
              np.maximum(bmin, bmax)[g:g + G].max(axis=0)) for g in range(0, n, G)]
    gate_hit, gate_nan = _hits(o, d, np.stack([lo for lo, _ in gates]),
                               np.stack([hi for _, hi in gates]))
    gate_hit |= gate_nan
    ids = np.arange(n) // S
    total = 0
    for r in np.flatnonzero(alive):
        rows = np.flatnonzero(hit[r])
        second = rows[ids[rows] != ids[rows[0]]] if rows.size else rows
        end = int(second[0]) + 1 if second.size else n  # rows tested up to here
        for g, j0 in enumerate(range(0, n, G)):
            if j0 >= end:
                break
            total += 1 + (min(j0 + G, end) - j0 if gate_hit[r, g] else 0)
    return total


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_bit_equal_to_plain(host, case):
    seed, R, K, S = CASES[case][:4]
    o, d, alive, bmin, bmax = _boxes(*CASES[case])
    rows = _rows(o, d, alive)
    tb_min, tb_max = torch.from_numpy(bmin), torch.from_numpy(bmax)
    counted = set()
    for count in (False, True):
        for chunk in (R, 48):
            want_keys, want_live = rays.cullhit_keys(rows, tb_min, tb_max, K, S, count, chunk)
            for lanes in (1, 8, 32):
                got_keys, got_live, tests = _host_keys(host, rows, tb_min, tb_max, K, S, count,
                                                       chunk, lanes)
                assert torch.equal(got_keys, want_keys) and torch.equal(got_live, want_live)
                counted.add(tests)
    assert counted == {_gated_tests_needed(o, d, alive, bmin, bmax, K, S)}
    assert rays.flat_box_tests(rows, tb_min, tb_max, K, S) == _tests_needed(
        o, d, alive, bmin, bmax, K, S)
    if case == "squeezed_far":  # the count bucket's clamp is exercised
        keys, _ = rays.plain_cullhit_keys(rows, tb_min, tb_max, K, S, False, R)
        assert ((keys[torch.from_numpy(alive)] >> 21) >= 1024).sum() > 10


def _edge_boxes(seed=11, K=75, S=2):
    """K * S boxes (a ragged last gate group) and rays on the slab test's
    edges: subnormal direction components (an infinite inverse) from origins
    on a box plane (a NaN plane parameter), inverted boxes, empty sub-boxes
    as far point boxes (split_aabbs') hit by rays along the diagonal, and
    rays whose only hits lie in the last gate's group."""
    r = np.random.default_rng(seed)
    n = K * S
    centers = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    half = r.uniform(0.1, 0.6, (n, 3)).astype(np.float32)
    bmin, bmax = centers - half, centers + half
    flip = r.uniform(size=n) < 0.2  # inverted on one axis
    axis = r.integers(0, 3, n)
    bmin[flip, axis[flip]], bmax[flip, axis[flip]] = (bmax[flip, axis[flip]].copy(),
                                                     bmin[flip, axis[flip]].copy())
    point = np.arange(1, n, 2)[r.uniform(size=n // 2) < 0.3]  # empty second sub-boxes
    bmin[point] = bmax[point] = 1e17
    last = (n - 1) // rays.CULLHIT_GATE * rays.CULLHIT_GATE  # the last group's first row
    bmin[last:, 1] += 100.0
    bmax[last:, 1] += 100.0
    R = 320
    o = r.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = r.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Subnormal components, origins on a box's plane on that axis, or on its
    # gate's least plane (the gate's test NaN, its members' not).
    G = rays.CULLHIT_GATE
    for k in range(64):
        box, ax = r.integers(0, last), k % 3
        d[k, ax] = np.float32(1e-40) * (1 if k % 2 else -1)
        group = np.minimum(bmin, bmax)[box // G * G:(box // G + 1) * G, ax]
        o[k, ax] = (bmin[box, ax], bmax[box, ax], group.min(), group.min())[k % 4]
    # Along the diagonal from the origin: the far point boxes tie.
    o[64:72] = 0.0
    d[64:72] = np.float32(0.57735026)
    # Inside the last group's boxes, heading up: their only hits lie there.
    inside = r.choice(np.setdiff1d(np.arange(last, n), point), 48)
    o[72:120] = centers[inside] + np.array([0.0, 100.0, 0.0], np.float32)
    d[72:120] = np.array([0.0, 1.0, 0.0], np.float32)
    # All three components subnormal from the first gate's least x plane:
    # that gate's test is NaN, while its members above the plane, straddling
    # the origin in y and z, hit at near = far = inf.
    lo0 = np.minimum(bmin, bmax)[:G]
    members = np.flatnonzero((lo0[:, 0] > lo0[:, 0].min()) & ~np.isin(np.arange(G), point))
    o[120:128] = centers[r.choice(members, 8)]
    o[120:128, 0] = lo0[:, 0].min()
    d[120:128] = np.float32(1e-40)
    alive = r.uniform(size=R) < 0.95
    alive[120:128] = True
    return o, d, alive, bmin, bmax, K, S, last


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_host_build_bit_equal_on_edge_rows(host, lanes):
    o, d, alive, bmin, bmax, K, S, last = _edge_boxes()
    rows = _rows(o, d, alive)
    tb_min, tb_max = torch.from_numpy(bmin), torch.from_numpy(bmax)
    for count in (False, True):
        want = rays.plain_cullhit_keys(rows, tb_min, tb_max, K, S, count, 100)
        for staged in (32, 64, 0):
            got_keys, got_live, tests = _host_keys(host, rows, tb_min, tb_max, K, S, count,
                                                   100, lanes, staged)
            assert torch.equal(got_keys, want[0]) and torch.equal(got_live, want[1])
            assert tests == _gated_tests_needed(o, d, alive, bmin, bmax, K, S)
    # The edges are reached: NaN plane parameters, point-box and last-group
    # hits, hits at infinity behind a NaN gate.
    hit, nan = _hits(o, d, bmin, bmax)
    assert nan[:64].any(axis=1).sum() > 20
    assert hit[64:72][:, (bmin == 1e17).all(axis=1)].any()
    keys, _ = rays.plain_cullhit_keys(rows, tb_min, tb_max, K, S, False, 100)
    fh = keys.numpy() >> 21 & 0x7FF
    assert (fh[72:120][alive[72:120]] >= last // S).all()
    assert (fh[72:120][alive[72:120]] < K).all()
    assert (fh[120:128] < rays.CULLHIT_GATE // S).all()


def test_gates_are_the_tight_super_boxes_of_both_corners():
    o, d, alive, bmin, bmax, K, S, _ = _edge_boxes()
    for lo, hi, n in ((bmin, bmax, K * S), *((b[0], b[1], CASES["squeezed_split"][2] * 2)
                                            for b in [_boxes(*CASES["squeezed_split"])[3:]])):
        boxes, gates = rays.cullhit_tables(torch.from_numpy(lo), torch.from_numpy(hi), n)
        G = rays.CULLHIT_GATE
        assert boxes.shape == (n, 8) and gates.shape == (-(-n // G), 8)
        assert np.array_equal(boxes[:, 0:3].numpy(), lo[:n])
        assert np.array_equal(boxes[:, 4:7].numpy(), hi[:n])
        for g in range(gates.shape[0]):
            corners = np.concatenate([lo[g * G:(g + 1) * G], hi[g * G:(g + 1) * G]])
            assert np.array_equal(gates[g, 0:3].numpy(), corners.min(axis=0))
            assert np.array_equal(gates[g, 4:7].numpy(), corners.max(axis=0))
        assert not boxes[:, [3, 7]].any() and not gates[:, [3, 7]].any()


def test_host_build_on_torus_rows(host):
    """The small torus's cluster boxes and a traced wavefront's rows
    (bounce 1, Morton-sorted, some rays dead)."""
    _, ts = build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                            dict(width=16, height=16, rays_per_pixel=4, bounces=2), sky=True)
    state = wavefront.make_initial_state(ts, torch.arange(1024, dtype=torch.int32), 4, 3)
    state, _ = wavefront.process_rays(ts, state, 3, 0)
    rows = wavefront.pack_rows(state)
    K, S = ts.num_clusters, ts.config.cull_split
    for count in (False, True):
        want = rays.cullhit_keys(rows, ts.cluster_min, ts.cluster_max, K, S, count, 1024)
        for lanes in (1, 8, 32):
            got = _host_keys(host, rows, ts.cluster_min, ts.cluster_max, K, S, count, 1024,
                             lanes)[:2]
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    alive = rays.rows_alive(rows)
    assert 0 < int(alive.sum()) < 1024
    ref = np.asarray(jmorton.first2_cluster_keys(
        jnp.asarray(rows[:, 0:3].numpy()), jnp.asarray(rows[:, 3:6].numpy()),
        jnp.asarray(alive.numpy()), jnp.asarray(ts.cluster_min.numpy()),
        jnp.asarray(ts.cluster_max.numpy()), K, S))
    plain, _ = rays.plain_cullhit_keys(rows, ts.cluster_min, ts.cluster_max, K, S, False, 1024)
    np.testing.assert_array_equal(plain.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("engine", ["count", "argsort"])
def test_cullhit_render_bit_identical_to_morton(engine):
    _, ts = build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                            dict(width=16, height=16, rays_per_pixel=4, bounces=4,
                                 sort_engine=engine), sky=True)
    assert wavefront.resolved_intersector(ts) == "packet"
    ref = pipeline.render_framebuffer(ts)
    for key in ("cullhit", "auto"):
        scene = ts.with_config(sort_key=key)
        assert wavefront.sort_key_mode(scene) == "cullhit"
        assert torch.equal(pipeline.render_framebuffer(scene), ref)
    # Brute and BVH scenes keep the Morton key under "auto" and "cullhit".
    assert wavefront.sort_key_mode(ts.with_config(sort_key="auto", intersector="bvh")) == \
        "morton"
    assert wavefront.sort_key_mode(ts.with_config(sort_key="cullhit", intersector="brute")) \
        == "morton"


def test_bucket_sort_dest_matches_jax():
    r = np.random.default_rng(4)
    for n in (2048, 777, 300):
        keys = r.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
        keys[r.random(n) < 0.3] = jmorton.DEAD_RAY_KEY
        keys[:20] = np.uint32(0x7FFF0000)  # live keys in the clamped top bucket
        if n == 300:
            keys[:] = jmorton.DEAD_RAY_KEY
        ref = np.asarray(jsort.bucket_sort_dest(jnp.asarray(keys)))
        got = sort.bucket_sort_dest(torch.from_numpy(keys.astype(np.int64)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="2\\^24"):
        sort.bucket_sort_dest(torch.zeros(1 << 24, dtype=torch.int64))
    assert (sort.BLK, sort.BUCKETS, sort.BUCKET_SHIFT) == (jsort.BLK, jsort.BUCKETS,
                                                           jsort.BUCKET_SHIFT)


@pytest.mark.parametrize("key", ["morton", "cullhit"])
def test_bucket_sort_dest_inverts_sort_order(key):
    """On one chunk of rows, the destinations of the count engine's keys
    are the inverse of ``sort_order``'s gather permutation."""
    _, ts = build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                            dict(width=16, height=16, rays_per_pixel=2, bounces=2,
                                 sort_engine="count", sort_key=key), sky=True)
    state = wavefront.make_initial_state(ts, torch.arange(512, dtype=torch.int32), 2, 1)
    state, _ = wavefront.process_rays(ts, state, 1, 0)
    rows = wavefront.pack_rows(state)
    order, _ = wavefront.sort_order(ts, rows, 512)
    if key == "cullhit":
        keys = morton.first2_cluster_keys(rows[:, 0:3], rows[:, 3:6], rays.rows_alive(rows),
                                          ts.cluster_min, ts.cluster_max, ts.num_clusters,
                                          ts.config.cull_split)
    else:
        keys = morton.ray_sort_keys(rows[:, 0:3], rows[:, 3:6], rays.rows_alive(rows),
                                    ts.min_coord, ts.inv_extent)
    dest = sort.bucket_sort_dest(keys).long()
    assert torch.equal(dest[order], torch.arange(512))


def test_random01_and_random_on_sphere_match_jax():
    seeds = np.random.default_rng(0).integers(0, 1 << 32, 5000, dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    jstate = jrng.srand(jnp.asarray(seeds))
    tstate = rng.srand(torch.from_numpy(seeds.astype(np.int64)))
    for _ in range(2):
        jstate, jv = jrng.random01(jstate)
        tstate, tv = rng.random01(tstate)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jstate, jp = jrng.random_on_sphere(jstate)
        tstate, tp = rng.random_on_sphere(tstate)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        for limb_t, limb_j in zip(tstate, (jstate.hi, jstate.lo)):
            np.testing.assert_array_equal(limb_t.numpy(), np.asarray(limb_j).astype(np.int64))
    assert tp.shape == (5000, 3)
