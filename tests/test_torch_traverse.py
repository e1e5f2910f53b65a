"""The BVH intersector (``intersector="bvh"``) of the port against the JAX package, on the CPU.

``csrc/traverse.cu`` runs only on the GPU, where ``chip_smoke.py`` (phase 13)
holds it against its plain version. The walk's one dispatch point is
``ops/kernels/traverse.bvh_walk`` (the plain version on a CPU tensor). Its per-ray walk is
``csrc/traverse.cuh``, which ``csrc/traverse_host.cpp`` runs on the host;
this file builds that with the host C++ compiler (``-ffp-contract=off``,
like the GPU build's ``-fmad=false``) and holds, on seeded inputs:

- ``intersect.ray_aabb`` EQUAL to JAX's (hit bits, entry values), zero
  direction components and NaN planes included;
- the plain lockstep walk (``traverse.plain_bvh_closest_hit``) against JAX
  ``ops/traverse.py`` ``bvh_closest_hit`` on the small torus and a
  700-triangle random cloud, camera and random rays, several tile sizes
  with a ragged last tile: indices EQUAL, t within rtol 1e-6 (the brute
  scan's standard in test_torch_primitives.py: XLA's CPU backend contracts
  multiply-adds into FMAs);
- the walk against the port's brute scan at JAX's tests/test_bvh.py
  standard (t within rtol / atol 1e-5, under 1 % of indices different,
  on ties);
- the walk tables (``ops/kernels/traverse.walk_tables``) against the node
  arrays exactly: each record's boxes (bits) and words, the rows in
  breadth-first order, every inner word naming its child's row;
- the host build BIT-EQUAL to the plain walk (strided rows, dead rays,
  finite windows), its counters against the walk's structure, on grids of
  32, 8, 5 and 1 rays a warp, and the max-pops counter equal to the
  largest of one-ray calls' pop counts;
- the wrapper refusing a tree deeper than MAX_BVH_DEPTH and bad inputs;
- renders (16×16 × 4 spp × 4 bounces, torus and glass torus) through BVH
  against JAX's BVH at the render gate of tests/test_torch_mesh_render.py,
  and a graph-building trace (detached and reparameterised) with its
  gradients at tests/test_torch_diff.py's gate (a Cornell trace through
  BVH: tests/test_torch_render.py).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops import intersect as jintersect
from cuda_raytracer_tpu.ops import traverse as jtraverse
from cuda_raytracer_tpu.render import pipeline as jpipeline

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.models.bvh import MAX_BVH_DEPTH
from cuda_raytracer_tpu_torch.ops import intersect, traverse
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.render import pipeline, wavefront

from test_bvh import random_triangles
from test_torch_diff import _assert_grads_close, _grads_both
from test_torch_mesh_render import assert_pixels_agree
from test_torch_packet import build_mesh_both
from test_torch_rays import _compile

RENDER = dict(width=16, height=16, rays_per_pixel=4, bounces=4)


def _cloud_text():
    p1, p2, p3 = random_triangles(700, seed=7, spread=5.0)
    lines = ["material m diffuse 0.5 0.5 0.5"]
    lines += ["triangle m " + " ".join(f"{v:.6f}" for v in np.concatenate([a, b, c]))
              for a, b, c in zip(p1, p2, p3)]
    lines += ["camera position 0 0 -20 forward 0 0 1 up 0 1 0 fov 45", "image 8 8 1 3 1"]
    return "\n".join(lines)


@pytest.fixture(scope="module")
def scenes():
    torus = build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                            dict(width=16, height=16, rays_per_pixel=2), sky=True)
    cloud = build_mesh_both(_cloud_text(), dict(width=16, height=16, rays_per_pixel=2))
    assert cloud[1].bvh_node_count > 1 and torus[1].triangle_count == 770
    return {"torus": torus, "cloud": cloud}


def _random_rays(ts, n, seed):
    """Rays from the scene's bounding box grown by 1 in random unit
    directions; ``closest`` open (1e30), finite on a fifth, -1 (dead) on a
    tenth; ``index`` -1, or a sphere-like 0 where the window is finite."""
    rng = np.random.default_rng(seed)
    lo, hi = ts.bvh_min[0].numpy(), ts.bvh_max[0].numpy()
    origin = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    direction[:8, 1] = 0.0  # axis-parallel: the safe inverse's ±1e30
    closest = np.full(n, 1e30, np.float32)
    index = np.full(n, -1, np.int32)
    finite = rng.random(n) < 0.2
    closest[finite] = rng.uniform(0.5, 8.0, finite.sum())
    index[finite] = 0
    closest[rng.random(n) < 0.1] = -1.0
    return origin, direction, closest, index


def _camera_rays(js, ts, n):
    ids = np.arange(n, dtype=np.int32)
    st = wavefront.make_initial_state(ts, torch.from_numpy(ids), 2, 3)
    o, d = st.origin.numpy(), st.direction.numpy()
    closest = np.full(n, 1e30, np.float32)
    return o, d, closest, np.full(n, -1, np.int32)


def _rays(kind, js, ts):
    if kind == "camera":
        return _camera_rays(js, ts, 512)
    return _random_rays(ts, 1000, seed=5)


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(3)
    n = 4000
    origin = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:500, 0] = 0.0
    d[500:700, 1:] = -0.0
    inv = traverse._safe_inv_dir(torch.from_numpy(d)).numpy()
    inv[700:720] = np.float32(np.inf)  # 0 * inf: NaN planes
    lo = rng.uniform(-1, 0.5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 2.5, (n, 3)).astype(np.float32)
    origin[700:760] = lo[700:760]  # origins on a box face (0 * inf above)
    tmax = rng.uniform(-1, 5, n).astype(np.float32)
    args = (origin, inv, lo, hi, tmax)
    jhit, jt = jintersect.ray_aabb(*map(jnp.asarray, args))
    thit, tt = intersect.ray_aabb(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert 0.1 < thit.numpy().mean() < 0.9 and np.isnan(tt.numpy()).any()


@pytest.mark.parametrize("name", ["torus", "cloud"])
@pytest.mark.parametrize("kind,tile", [("camera", 1 << 15), ("camera", 96),
                                       ("random", 1000), ("random", 256)])
def test_plain_walk_matches_jax(scenes, name, kind, tile):
    js, ts = scenes[name]
    o, d, c, i = _rays(kind, js, ts)
    jt, ji = jtraverse.bvh_closest_hit(js, *map(jnp.asarray, (o, d, c, i)))
    tt, ti = traverse_kernel.bvh_walk(ts, *map(torch.from_numpy, (o, d, c, i)),
                                      tile_size=tile)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    hits = ti.numpy() >= ts.sphere_count
    assert hits.sum() > 0.2 * len(hits) and (tt.numpy()[c < 0] == -1).all()


@pytest.mark.parametrize("name", ["torus", "cloud"])
def test_walk_matches_brute_scan(scenes, name):
    _, ts = scenes[name]
    o, d, _, _ = map(torch.from_numpy, _random_rays(ts, 1000, seed=9))
    t0 = torch.full((1000,), intersect.MISS)
    i0 = torch.full((1000,), -1, dtype=torch.int32)
    t_bvh, i_bvh = traverse_kernel.bvh_walk(ts, o, d, t0, i0)
    t_brute, i_brute = intersect.intersect_triangles_brute(o, d, ts.tri_p1, ts.tri_e1,
                                                           ts.tri_e2)
    i_brute = torch.where(i_brute >= 0, ts.sphere_count + i_brute, i_brute)
    np.testing.assert_allclose(t_bvh.numpy(), t_brute.numpy(), rtol=1e-5, atol=1e-5)
    assert (i_bvh != i_brute).float().mean() < 0.01
    assert (i_bvh >= 0).sum() > 100


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = _compile(tmp_path_factory, "traverse_host")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_host_bvh_walk.argtypes = [p, i, p, i, p, p, i, p, p] + [i] * 6 + [p, p, p]
    return lib


def _host_walk(lib, ts, rows, closest, index, grid=(2, 32)):
    """The host build on the origin and direction columns of (n, 16) rows,
    on a grid of (blocks, lanes): blocks of the kernel's 128 threads taking
    ``lanes`` rays a warp. Rays no lane takes come out NaN."""
    n = rows.shape[0]
    tb = traverse_kernel.walk_tables(ts)
    t = torch.full((n,), float("nan"))
    idx = torch.full((n,), -7, dtype=torch.int32)
    stats = torch.zeros(4, dtype=torch.int64)
    lib.rt_host_bvh_walk(
        rows.data_ptr(), rows.stride(0), rows[:, 3:].data_ptr(), rows.stride(0),
        closest.data_ptr(), index.data_ptr(), n, tb.records.data_ptr(),
        tb.triangles.data_ptr(), *tb.root, max(ts.max_leaf_size, 1), ts.sphere_count,
        *grid, t.data_ptr(), idx.data_ptr(), stats.data_ptr())
    return t, idx, stats


def _rows_of(o, d):
    rows = torch.zeros((o.shape[0], 16))
    rows[:, 0:3], rows[:, 3:6] = o, d
    return rows


@pytest.mark.parametrize("name", ["torus", "cloud"])
def test_host_build_bit_equal_to_plain_walk(scenes, host, name):
    js, ts = scenes[name]
    o, d, c, i = map(torch.from_numpy, _random_rays(ts, 1000, seed=11))
    rows = _rows_of(o, d)
    got_t, got_i, stats = _host_walk(host, ts, rows, c, i)
    want_t, want_i = traverse.plain_bvh_closest_hit(ts, rows[:, 0:3], rows[:, 3:6], c, i, 256)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    # Counters: a dead ray pops its root and does nothing else; every slab
    # test comes in a pair; every live ray pops at least the root.
    dead = c < 0
    _, _, dead_stats = _host_walk(host, ts, rows[dead], c[dead], i[dead])
    assert dead_stats.tolist() == [int(dead.sum()), 0, 0, 1]
    assert stats[0] > 1000 and stats[1] % 2 == 0 and stats[2] > 0


def _node_levels(ts):
    """Each node's level below the root, walked one node at a time."""
    c1, c2 = ts.bvh_child1.tolist(), ts.bvh_child2.tolist()
    level, todo = {0: 0}, [0]
    while todo:
        node = todo.pop()
        if c2[node] > c1[node]:
            for child in (c1[node], c2[node]):
                level[child] = level[node] + 1
                todo.append(child)
    return level


@pytest.mark.parametrize("name", ["torus", "cloud"])
def test_walk_tables_match_node_arrays(scenes, name):
    """Every record against the node arrays, exactly: its row's node, both
    children's boxes (bits) and words; the rows breadth-first, so the first
    rows are the tree's top levels; every inner word naming its child's
    row. Triangle records: p1, e1, e2 and zeros."""
    _, ts = scenes[name]
    tb = traverse_kernel.walk_tables(ts)
    c1, c2 = ts.bvh_child1.long(), ts.bvh_child2.long()
    inner = (c2 > c1).nonzero()[:, 0]
    rec, nodes = tb.records, torch.from_numpy(tb.nodes)
    assert rec.dtype == torch.int32 and rec.shape == (inner.numel(), 16)
    assert torch.equal(nodes.sort().values, inner)  # each inner node once
    level = _node_levels(ts)
    levels = torch.tensor([level[n] for n in tb.nodes.tolist()])
    assert nodes[0] == 0 and bool((levels[1:] >= levels[:-1]).all())
    assert levels[-1] + 1 == traverse_kernel.tree_depth(ts.bvh_child1, ts.bvh_child2)
    row = torch.full((c1.numel(),), -1, dtype=torch.long)
    row[nodes] = torch.arange(nodes.numel())
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    for k, child in enumerate((c1[nodes], c2[nodes])):
        assert torch.equal(rec[:, 6 * k:6 * k + 3], bits(ts.bvh_min[child]))
        assert torch.equal(rec[:, 6 * k + 3:6 * k + 6], bits(ts.bvh_max[child]))
        first, second = rec[:, 12 + 2 * k].long(), rec[:, 13 + 2 * k].long()
        leaf = c2[child] <= c1[child]
        assert torch.equal(first[leaf], c1[child][leaf])
        assert torch.equal(second[leaf], c2[child][leaf])
        assert torch.equal(first[~leaf], row[child][~leaf])
        assert bool((nodes[first[~leaf]] == child[~leaf]).all())
        assert bool((second[~leaf] == traverse_kernel.INNER_WORD).all())
    assert tb.root == (0, traverse_kernel.INNER_WORD)
    assert torch.equal(tb.triangles, torch.cat([ts.tri_p1, ts.tri_e1, ts.tri_e2,
                                                torch.zeros_like(ts.tri_p1)], dim=1))


@pytest.mark.parametrize("name", ["torus", "cloud"])
@pytest.mark.parametrize("grid", [(1, 32), (3, 5), (5, 1), (2, 8)])
def test_host_build_grids_bit_equal(scenes, host, name, grid):
    """The host build on grids that deal chunks of 32, 5, 1 and 8 rays a
    warp round one to five blocks (each thread's stack a column of the
    block's shared array): bit-equal to the plain walk, every ray written,
    the same work counted as on the default grid."""
    _, ts = scenes[name]
    o, d, c, i = map(torch.from_numpy, _random_rays(ts, 700, seed=13))
    rows = _rows_of(o, d)
    want_t, want_i = traverse.plain_bvh_closest_hit(ts, rows[:, 0:3], rows[:, 3:6], c, i)
    got_t, got_i, stats = _host_walk(host, ts, rows, c, i, grid)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    _, _, default = _host_walk(host, ts, rows, c, i)
    assert stats.tolist() == default.tolist()  # the same walk, entry for entry


@pytest.mark.parametrize("name", ["torus", "cloud"])
def test_max_pops_counter(scenes, host, name):
    """The fourth counter is the largest per-ray pop count: equal to the
    largest of one-ray calls' pop counts, and their sum to the batch's."""
    _, ts = scenes[name]
    o, d, c, i = map(torch.from_numpy, _random_rays(ts, 200, seed=17))
    rows = _rows_of(o, d)
    _, _, stats = _host_walk(host, ts, rows, c, i)
    pops = [int(_host_walk(host, ts, rows[k:k + 1], c[k:k + 1], i[k:k + 1])[2][0])
            for k in range(200)]
    assert stats[3] == max(pops) > 1 and stats[0] == sum(pops)


def _chain(depth):
    """A BVH that is a chain of ``depth`` inner nodes (the deepest leaf at
    level ``depth``) over one triangle: (min, max, child1, child2)."""
    child1, child2 = [], []
    for k in range(depth):  # inner node 2k: child1 a leaf, child2 the next inner node
        child1 += [2 * k + 1, 0]
        child2 += [2 * k + 2, 0]
    child1.append(1)  # the last node: a leaf holding triangle 0
    child2.append(0)
    n = len(child1)
    box = torch.tensor([[-10.0, -10.0, -10.0]]).repeat(n, 1)
    return (box, -box, torch.tensor(child1, dtype=torch.int32),
            torch.tensor(child2, dtype=torch.int32))


def test_wrapper_refuses_deep_trees_and_bad_inputs(scenes):
    _, ts = scenes["torus"]
    assert traverse_kernel.tree_depth(ts.bvh_child1, ts.bvh_child2) <= MAX_BVH_DEPTH
    o, d, c, i = map(torch.from_numpy, _random_rays(ts, 64, seed=1))
    ok = dict(zip(("bvh_min", "bvh_max", "bvh_child1", "bvh_child2"), _chain(MAX_BVH_DEPTH)))
    deep = dict(zip(("bvh_min", "bvh_max", "bvh_child1", "bvh_child2"),
                    _chain(MAX_BVH_DEPTH + 1)))
    assert traverse_kernel.tree_depth(ok["bvh_child1"], ok["bvh_child2"]) == MAX_BVH_DEPTH
    t, idx = traverse_kernel.bvh_walk(ts.replace(**ok), o, d, c, i)
    assert t.shape == (64,)
    with pytest.raises(ValueError, match="MAX_BVH_DEPTH"):
        traverse_kernel.bvh_walk(ts.replace(**deep), o, d, c, i)
    with pytest.raises(ValueError, match="int32"):
        traverse_kernel.bvh_walk(ts, o, d, c, i.long())
    with pytest.raises(ValueError, match="origin"):
        traverse_kernel.bvh_walk(ts, o.double(), d, c, i)
    with pytest.raises(ValueError, match="direction"):
        traverse_kernel.bvh_walk(ts, o, d.t().contiguous().t(), c, i)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        traverse_kernel.bvh_walk(ts, o, d, c, i, stats=torch.zeros(4, dtype=torch.int64))
    for child in ("bvh_child1", "bvh_child2"):  # children on another device than the rays
        with pytest.raises(ValueError, match="tensors on meta"):
            traverse_kernel.bvh_walk(ts.replace(**{child: getattr(ts, child).to("meta")}),
                                     o, d, c, i)


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_bvh_render_matches_jax(name):
    text = builtin_scenes.MESH_SCENES[name](builtin_scenes.SMALL)
    js, ts = build_mesh_both(text, dict(RENDER, intersector="bvh"), sky=True)
    assert wavefront.resolved_intersector(ts) == "bvh"
    ref = np.asarray(jpipeline.render_framebuffer(js))
    fb = pipeline.render_framebuffer(ts)
    assert fb.shape == (256, 3)
    assert_pixels_agree(fb.numpy(), ref)
    img = pipeline.render_image(ts, framebuffer=fb)
    assert 20 <= img.mean() <= 235


@pytest.mark.parametrize("reparam", [False, True])
def test_bvh_graph_trace_matches_jax(reparam):
    """A graph-building trace (``trace_rays``) through the BVH: loss and
    gradients of a weighted render, against JAX's."""
    js, ts = build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                             dict(width=8, height=8, rays_per_pixel=2, bounces=3,
                                  intersector="bvh"), sky=True)
    j_loss, t_loss, grads = _grads_both(js, ts, reparam, rpp=2, bounces=3)
    assert abs(t_loss - j_loss) <= 1e-4 * abs(j_loss)
    _assert_grads_close(grads)
    assert grads["materials.metallicity"][1][0] != 0.0
