"""The packet kernels' shared bodies, compiled for the host, against their plain versions.

``cuda_raytracer_tpu_torch/csrc/cull.cu``, ``fused.cu``, ``fused1.cu`` and
``sweep.cu`` run only on the GPU, where ``chip_smoke.py`` holds them against the plain
PyTorch versions. Everything they compute, though, is in ``csrc/packet.cuh``
as per-block drivers templated over an executor; ``csrc/packet_host.cpp``
runs the same drivers over the grid as a loop on the host. This test builds
that file with the host C++ compiler (``-ffp-contract=off``, like the GPU
build's ``-fmad=false``) and holds every output BIT-EQUAL to the plain
version: the cull's entries and hit words (flat, and gated with all-ones,
real and cleared gates), and the (t, tri) of fused (with
and without the skip test) and fused1 (flat and gated; over one box per
block, and over paired sub-cluster blocks with ``pack=2``, whose counters
equal the unpacked table's at C/2), and the pair
sweep's (t, tri) over a pair list in tile-major and shuffled order with
sentinels, on a torus cut into more than one 128-box chunk, with finite
windows, dead rays and ray counts that do not fill the last tile. The split
fused1 (a tile's boxes over several blocks, folded through 64-bit keys) and
the split fused (a tile's selected clusters over several blocks, the same
fold; its staging double-buffered, which the host build copies at once) are
held to the same bits at every split, with and without fused's skip test,
and their unsplit counters to a PyTorch recount of the kernel's walk. The
sweep's contiguous pair ranges are held to the same bits at several range
counts, pair orders and cluster widths, its sign-free Möller–Trumbore
acceptance to the sign-folded one on edge values, and the one-launch
hierarchical cull (each chunk's gate computed from its super boxes) to the
flat cull and the plain two-step form.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.ops.intersect import MISS
from cuda_raytracer_tpu_torch.ops.kernels import build, cull, fused, fused1, sweep
from cuda_raytracer_tpu_torch.ops.traverse import _safe_inv_dir

SKIP_SLACK = 0.99993896484375  # rt::kSkipSlack


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = tmp_path_factory.mktemp("packet_host") / "libpacket_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib_path), str(build.CSRC_DIR / "packet_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_host_cull_tiles.argtypes = [p] * 4 + [i] * 3
    lib.rt_host_cull_tiles_gated.argtypes = [p] * 4 + [i] + [p] * 2 + [i] * 3
    lib.rt_host_fused_closest_hit.argtypes = [p] * 3 + [i] + [p] * 2 + [i] * 5 + [p] * 3
    lib.rt_host_fused1_closest_hit.argtypes = [p] * 3 + [i] * 2 + [p] + [i] * 7 + [p] * 3
    lib.rt_host_sweep_pairs.argtypes = [p] + [i] * 3 + [p] + [i] * 2 + [p, i, p, i] + [p] * 3
    lib.rt_host_mt_accept.argtypes = [p] * 4 + [i] + [p] * 2
    return lib


@pytest.fixture(scope="module")
def scene():
    """A torus cut into ~290 clusters of <= 32 triangles: three cull chunks."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    s = scene_dsl.assemble_scene(parsed, config_overrides=dict(width=8, height=8),
                                 prefer_native_bvh=False, cluster_tris=32, device="cpu")
    assert s.num_clusters > 2 * fused1.CHUNK
    return s


def _od8(n, tile, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 2.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.full(n, 1e30, np.float32)
    w[: n // 4] = rng.uniform(0.3, 3.0, n // 4)
    w[n // 4: n // 4 + 9] = -1.0
    rays = packet_intersect._pad_rays(*(torch.from_numpy(a) for a in (o, d, w)), tile)
    return cull.make_od8(*rays, tile)


def _coherent_od8(n, tile, seed):
    """Rays in coherent tiles, as a camera or a sorted bounce gives them:
    each tile's rays leave from near one point in a narrow cone, so a tile
    hits a few clusters; finite windows and dead rays as ``_od8``."""
    rng = np.random.default_rng(seed)
    T = -(-n // tile)
    o = np.repeat(rng.uniform(-2.5, 2.5, (T, 3)), tile, axis=0)[:n]
    o[:, 1] = np.repeat(rng.uniform(0.5, 2.0, T), tile)[:n]
    o += rng.normal(scale=0.02, size=(n, 3))
    d = np.repeat(rng.normal(size=(T, 3)), tile, axis=0)[:n]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(scale=0.05, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.full(n, 1e30)
    w[: n // 4] = rng.uniform(0.3, 3.0, n // 4)
    w[n // 4: n // 4 + 9] = -1.0
    rays = packet_intersect._pad_rays(
        *(torch.from_numpy(a.astype(np.float32)) for a in (o, d, w)), tile)
    return cull.make_od8(*rays, tile)


def _ptr(x):
    return None if x is None else x.data_ptr()


@pytest.mark.parametrize("n,tile", [(700, 64), (333, 32), (250, 100)])
def test_host_kernels_bit_equal_plain(host_lib, scene, n, tile):
    od8 = _od8(n, tile, seed=n)
    T = od8.shape[0]
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    K = aabb.shape[1]
    blocks = scene.cluster_blocks[:K].contiguous()
    C = blocks.shape[2]

    entry_ref, mask_ref = cull.plain_cull(od8, aabb, with_mask=True)
    entry, mask = torch.empty_like(entry_ref), torch.empty_like(mask_ref)
    host_lib.rt_host_cull_tiles(_ptr(od8), _ptr(aabb), _ptr(entry), _ptr(mask), T, K, tile)
    assert torch.equal(entry, entry_ref) and torch.equal(mask, mask_ref)

    select = entry_ref < cull.MISS_ENTRY * 0.5
    words = fused.pack_words(select)
    t_ref, tri_ref = fused.plain_fused(od8, blocks, words)
    assert (tri_ref >= 0).sum() > n // 10  # the case has hits to compare
    # The stats count only the work the data needs: live rays, real triangles.
    live = (od8[:, 6, :] >= 0).sum(dim=1)
    real = (blocks[:, 9, :] >= 0).sum(dim=1)
    assert int(real.min()) < C  # some clusters are padded
    pairs, mt_tests = int(select.sum()), int((select * live[:, None] * real).sum())
    for skip in (False, True):
        t, tri = torch.empty_like(t_ref), torch.empty_like(tri_ref)
        stats = torch.zeros(3, dtype=torch.int64)
        host_lib.rt_host_fused_closest_hit(
            _ptr(od8), _ptr(blocks), _ptr(words), words.shape[1],
            _ptr(entry_ref) if skip else None, _ptr(mask_ref) if skip else None,
            T, K, C, tile, 1, _ptr(t), _ptr(tri), _ptr(stats))
        assert torch.equal(t, t_ref) and torch.equal(tri, tri_ref), skip
        if skip:
            assert 0 < stats[1] <= pairs and 0 < stats[2] <= mt_tests
        else:
            assert (stats[1], stats[2]) == (pairs, mt_tests)

    t1_ref, tri1_ref = fused1.plain_fused1(od8, aabb, blocks)
    assert torch.equal(t1_ref, t_ref) and torch.equal(tri1_ref, tri_ref)
    for gate in (0, 16):
        sup = fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate) if gate else None
        t, tri = torch.empty_like(t_ref), torch.empty_like(tri_ref)
        stats = torch.zeros(3, dtype=torch.int64)
        host_lib.rt_host_fused1_closest_hit(
            _ptr(od8), _ptr(aabb), _ptr(sup), 0 if sup is None else sup.shape[0], gate,
            _ptr(blocks), T, K, C, 1, tile, 1, fused1.CHUNK, _ptr(t), _ptr(tri), _ptr(stats))
        assert torch.equal(t, t1_ref) and torch.equal(tri, tri1_ref), gate
        assert 0 < stats[0] <= int(live.sum()) * K
        assert 0 < stats[1] <= pairs and 0 < stats[2] <= mt_tests


@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_gated_cull_bit_equal_plain(host_lib, scene, n, tile):
    """The gated driver over a table padded to whole 128-box chunks."""
    od8 = _od8(n, tile, seed=n + 1)
    T = od8.shape[0]
    K = scene.num_clusters
    Kp = -(-K // cull.GATE_CHUNK) * cull.GATE_CHUNK
    far = torch.full((Kp - K, 3), 1e17)
    aabb = cull.box_table(torch.cat([scene.cluster_min, far]),
                          torch.cat([scene.cluster_max, far]))
    flat = cull.plain_cull(od8, aabb, with_mask=True)
    live = (flat[0] < cull.MISS_ENTRY * 0.5).reshape(T, -1, cull.GATE_CHUNK).any(dim=2)
    checker = live & ((torch.arange(T)[:, None] + torch.arange(live.shape[1])) % 2 == 0)
    for gate in (torch.ones_like(live), live, checker):
        gates = cull.pack_bits(gate[:, :, None]).reshape(-1)
        ref = cull.plain_cull_gated(od8, aabb, gates, with_mask=True)
        entry, mask = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        host_lib.rt_host_cull_tiles_gated(_ptr(od8), _ptr(aabb), _ptr(gates), None, 0,
                                          _ptr(entry), _ptr(mask), T, Kp, tile)
        assert torch.equal(entry, ref[0]) and torch.equal(mask, ref[1])
        if gate is not checker:
            assert torch.equal(entry, flat[0]) and torch.equal(mask, flat[1])
        entry_only = torch.empty_like(ref[0])
        host_lib.rt_host_cull_tiles_gated(_ptr(od8), _ptr(aabb), _ptr(gates), None, 0,
                                          _ptr(entry_only), None, T, Kp, tile)
        assert torch.equal(entry_only, ref[0])
    assert not torch.equal(checker, live)


@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_sweep_bit_equal_plain(host_lib, scene, n, tile):
    """The sweep driver over every culled pair, with (T, 0) sentinels past
    the count, in tile-major and in shuffled order: bit-equal to
    ``plain_sweep``, whose rows [:T] are the fused sweep's before the
    window clamp."""
    od8 = _od8(n, tile, seed=n + 2)
    T = od8.shape[0]
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    select = cull.plain_cull(od8, aabb) < cull.MISS_ENTRY * 0.5
    count = int(select.sum())
    pairs, total, _ = packet_intersect.extract_pairs(select, count + 40)
    origin = od8[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
    direction = od8[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
    rays = sweep.make_rays_tiles(origin, direction, tile)
    blocks = scene.cluster_blocks
    K, _, C = blocks.shape
    ref = sweep.plain_sweep(rays, blocks, pairs, total, tile)
    unclamped = fused.sweep_pair_list(od8, blocks, *torch.nonzero(select, as_tuple=True))
    assert torch.equal(ref[0][:T], unclamped[0]) and torch.equal(ref[1][:T], unclamped[1])
    assert (ref[1][:T] >= 0).sum() > n // 10
    shuffled = pairs.clone()
    shuffled[:, :count] = pairs[:, torch.from_numpy(np.random.default_rng(n).permutation(count))]
    for pair_list in (pairs, shuffled):
        keys = torch.empty((T + 1, tile), dtype=torch.int64)
        t, tri = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        host_lib.rt_host_sweep_pairs(_ptr(rays), T + 1, rays.shape[2], tile, _ptr(blocks),
                                     K, C, _ptr(pair_list), pair_list.shape[1], _ptr(total),
                                     1, _ptr(keys), _ptr(t), _ptr(tri))
        assert torch.equal(t, ref[0]) and torch.equal(tri, ref[1])


def _host_sweep(host_lib, rays, blocks, pairs, total, tile, ranges):
    T1 = rays.shape[0]
    K, _, C = blocks.shape
    keys = torch.empty((T1, tile), dtype=torch.int64)
    t = torch.empty((T1, tile), dtype=torch.float32)
    tri = torch.empty((T1, tile), dtype=torch.int32)
    assert host_lib.rt_host_sweep_pairs(_ptr(rays), T1, rays.shape[2], tile, _ptr(blocks), K,
                                        C, _ptr(pairs), pairs.shape[1], _ptr(total), ranges,
                                        _ptr(keys), _ptr(t), _ptr(tri)) == 0
    return t, tri


def _cuts_a_run(pairs, n, ranges):
    """Some range boundary of ``ranges`` over the first n pairs falls between
    two pairs of one tile."""
    return any(0 < n * r // ranges < n and int(pairs[0, n * r // ranges - 1])
               == int(pairs[0, n * r // ranges]) for r in range(1, ranges))


@pytest.fixture(scope="module")
def wide_scene():
    """The test torus in clusters of 256, the default width, which the
    sweep compiles for its own (padded: 27 clusters of ~256)."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    return scene_dsl.assemble_scene(parsed, config_overrides=dict(width=8, height=8),
                                    prefer_native_bvh=False, cluster_tris=256, device="cpu")


@pytest.fixture(scope="module")
def odd_scene():
    """The test torus in clusters of 30: a width that is no multiple of 4,
    which the sweep takes triangle by triangle."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    return scene_dsl.assemble_scene(parsed, config_overrides=dict(width=8, height=8),
                                    prefer_native_bvh=False, cluster_tris=30, device="cpu")


@pytest.mark.parametrize("width", [32, 256, 30])
@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_sweep_ranges_bit_equal_plain(host_lib, scene, wide_scene, odd_scene, width, n,
                                           tile):
    """The redesigned sweep driver (contiguous ranges of the pair list, each
    lane's running best folded into the keys when the tile changes and at a
    range's end) bit-equal to ``plain_sweep`` at 1 and 3 ranges, at a count
    whose ranges cut a tile's run of pairs and at one range per pair (and
    more ranges than pairs), over the tile-major list, a shuffled one and
    one whose total stops short of the selected pairs (the rest are
    sentinels and unswept pairs past ``total``); over clusters of 32, of
    256 triangles (the width compiled for its own) and of 30 (triangle by
    triangle), all with padding, and with each block's slots reversed."""
    scene = {32: scene, 256: wide_scene, 30: odd_scene}[width]
    assert scene.cluster_tris == width
    assert int((scene.cluster_blocks[:, 9, :] < 0).sum(dim=1).max()) >= 4  # padded quads
    od8 = _od8(n, tile, seed=n + 6)
    T = od8.shape[0]
    select = cull.plain_cull(od8, cull.box_table(scene.cluster_min, scene.cluster_max))
    select = select < cull.MISS_ENTRY * 0.5
    count = int(select.sum())
    pairs, total, _ = packet_intersect.extract_pairs(select, count + 40)
    origin = od8[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
    direction = od8[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
    rays = sweep.make_rays_tiles(origin, direction, tile)
    blocks = scene.cluster_blocks
    shuffled = pairs.clone()
    shuffled[:, :count] = pairs[:, torch.from_numpy(np.random.default_rng(n).permutation(count))]
    short = torch.tensor(count * 2 // 3, dtype=torch.int32)
    cutting = 7
    assert _cuts_a_run(pairs, count, cutting)
    # Each block's slots reversed (a fold is order-free): padding first, real
    # triangles in the last quads.
    flipped = blocks.flip(dims=[2]).contiguous()
    for pair_list, tot in ((pairs, total), (shuffled, total), (pairs, short)):
        ref = sweep.plain_sweep(rays, blocks, pair_list, tot, tile)
        assert (ref[1][:T] >= 0).sum() > n // 10
        for ranges in (1, 3, cutting, int(tot), pair_list.shape[1] + 5):
            for table in (blocks, flipped):
                t, tri = _host_sweep(host_lib, rays, table, pair_list, tot, tile, ranges)
                assert torch.equal(t, ref[0]) and torch.equal(tri, ref[1]), (int(tot), ranges)
    assert not torch.equal(sweep.plain_sweep(rays, blocks, pairs, short, tile)[1],
                           sweep.plain_sweep(rays, blocks, pairs, total, tile)[1])


def test_host_mt_acceptances_agree(host_lib):
    """The sweep's Möller–Trumbore acceptance (comparisons of the terms
    themselves, the other way round for det < 0) and the plain version's
    sign-folded one give the same answer on every quadruple of terms drawn
    from signed zeros, infinities, NaN, the bounds' own values and their
    neighbours (each ulp away), and on random terms around them."""
    eps = np.float32(0.005)
    base = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5,
                     eps, -eps, 3e-38, -3e-38, 1e-45, -1e-45], np.float32)
    base = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf)), eps * base])
    rng = np.random.default_rng(9)
    grid = np.stack(np.meshgrid(base, base, base, np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0,
                                                            np.inf, -np.inf, np.nan],
                                                           np.float32)), -1).reshape(-1, 4)
    det = rng.choice([-1.0, 1.0], 200000).astype(np.float32) * rng.uniform(1e-3, 4, 200000)
    rand = np.stack([rng.uniform(-0.2, 1.2, 200000) * det, rng.uniform(-0.2, 1.2, 200000) * det,
                     rng.uniform(0.0, 0.02, 200000) * det, det], -1).astype(np.float32)
    terms = torch.from_numpy(np.concatenate([grid, rand]).astype(np.float32).T.copy())
    n = terms.shape[1]
    folded, fast = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    host_lib.rt_host_mt_accept(*(_ptr(terms[i]) for i in range(4)), n, _ptr(folded), _ptr(fast))
    assert torch.equal(folded, fast)
    assert int(folded.sum()) > 10000 and int((folded == 0).sum()) > 10000  # both answers


@pytest.fixture(scope="module")
def split_scene():
    """The test torus with two sub-boxes a cluster (cull_split 2)."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    return scene_dsl.assemble_scene(parsed,
                                    config_overrides=dict(width=8, height=8, cull_split=2),
                                    prefer_native_bvh=False, cluster_tris=32, device="cpu")


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_hier_cull_bit_equal_flat_and_gated(host_lib, scene, split_scene, split, n, tile):
    """The one-launch hierarchical cull (each chunk's gate computed in the
    driver from its super boxes) in the host build, at cull_split 1 and 2
    (G = 16 boxes, G * S sub-boxes a super): bit-equal, with and without the
    hit words, to the flat ``plain_cull`` over the padded table, to
    ``plain_cull_gated`` behind ``hier_gates``' words and to
    ``plain_cull_hier``; and the gate skips chunks."""
    table = scene if split == 1 else split_scene
    od8 = _coherent_od8(n, tile, seed=n + 7)
    T = od8.shape[0]
    aabb_p, sup = packet_intersect.hier_tables(table.cluster_min, table.cluster_max, 16 * split)
    Kp = aabb_p.shape[1]
    n_chunks = Kp // cull.GATE_CHUNK
    assert n_chunks >= 3 and sup.shape[1] == Kp // (16 * split)
    flat = cull.plain_cull(od8, aabb_p, with_mask=True)
    gates = packet_intersect.hier_gates(od8, sup, n_chunks)
    gated = cull.plain_cull_gated(od8, aabb_p, gates, with_mask=True)
    on = int(cull.unpack_gates(gates, T, n_chunks).sum())
    assert 0 < on < T * n_chunks  # some chunks gated off, some on
    assert torch.equal(gated[0], flat[0]) and torch.equal(gated[1], flat[1])
    hier = cull.plain_cull_hier(od8, aabb_p, sup, with_mask=True)
    assert torch.equal(hier[0], flat[0]) and torch.equal(hier[1], flat[1])
    for with_mask in (True, False):
        entry = torch.empty_like(flat[0])
        mask = torch.empty_like(flat[1]) if with_mask else None
        host_lib.rt_host_cull_tiles_gated(_ptr(od8), _ptr(aabb_p), None, _ptr(sup),
                                          sup.shape[1], _ptr(entry), _ptr(mask), T, Kp, tile)
        assert torch.equal(entry, flat[0]), with_mask
        if with_mask:
            assert torch.equal(mask, flat[1])


@pytest.fixture(scope="module")
def packed_pair():
    """The same torus with ``cluster_pack=2`` at C = 64 (sub-clusters of 32,
    as ``scene`` is cut) and unpacked at 32."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    cfg = dict(width=8, height=8)
    packed = scene_dsl.assemble_scene(parsed, config_overrides=dict(cfg, cluster_pack=2),
                                      prefer_native_bvh=False, cluster_tris=64, device="cpu")
    half = scene_dsl.assemble_scene(parsed, config_overrides=cfg, prefer_native_bvh=False,
                                    cluster_tris=32, device="cpu")
    assert packed.num_clusters > 2 * fused1.CHUNK
    return packed, half


@pytest.fixture(scope="module")
def wide_pair():
    """A finer torus in clusters of 256 (171 clusters: two cull chunks) and
    paired at 256 (342 sub-clusters of 128): fused1's blocks sweep them in 8
    and 4 groups of lanes (``rt::fused1_shape``), where the narrow tables
    above take one."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (144, 96))
    cfg = dict(width=8, height=8)
    wide = scene_dsl.assemble_scene(parsed, config_overrides=cfg, prefer_native_bvh=False,
                                    cluster_tris=256, device="cpu")
    packed = scene_dsl.assemble_scene(parsed, config_overrides=dict(cfg, cluster_pack=2),
                                      prefer_native_bvh=False, cluster_tris=256, device="cpu")
    assert wide.num_clusters > fused1.CHUNK and packed.num_clusters > 2 * fused1.CHUNK
    return wide, packed


def _host_fused1(host_lib, od8, scene, gate, pack, splits=1):
    """The host build's fused1 loop over a scene's table, with ``splits``
    blocks per tile (split_plan's chunk) → (t, tri, stats)."""
    K = scene.num_clusters
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    blocks = scene.cluster_blocks[:K // pack].contiguous()
    sup = fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate) if gate else None
    T, _, tile = od8.shape
    splits, chunk = fused1.split_plan(T, K, gate, splits)
    t = torch.empty((T, tile), dtype=torch.float32)
    tri = torch.empty((T, tile), dtype=torch.int32)
    stats = torch.zeros(3, dtype=torch.int64)
    host_lib.rt_host_fused1_closest_hit(
        _ptr(od8), _ptr(aabb), _ptr(sup), 0 if sup is None else sup.shape[0], gate,
        _ptr(blocks), T, K, blocks.shape[2], pack, tile, splits, chunk, _ptr(t), _ptr(tri),
        _ptr(stats))
    return t, tri, stats


def _fused1_counters(od8, scene, gate, pack, prefetched_skips=None):
    """The unsplit kernel's counters recomputed in PyTorch: per tile, the
    128-box chunks in order (a gated chunk skipped unless some ray hits one
    of its super boxes), each hit box swept when some ray's bound min(best,
    window) reaches its entry scaled by SKIP_SLACK, the bests folded as
    the kernel folds → [slab tests, swept pairs, Möller–Trumbore tests].
    ``prefetched_skips``, a list, gets (tile, box) of every hit box that the
    early-out passes over after its block was copied while the chunk's
    previous hit box was handled."""
    K = scene.num_clusters
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    sub = fused1.sub_blocks(scene.cluster_blocks[:K // pack], pack)
    real = (sub[:, 9, :] >= 0).sum(dim=1)
    sup = fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate) if gate else None
    T, _, tile = od8.shape
    stats = [0, 0, 0]
    for t in range(T):
        o, d, win = od8[t, 0:3].T, od8[t, 3:6].T, od8[t, 6]
        n_live = int((win >= 0).sum())
        if not n_live:
            continue
        inv = _safe_inv_dir(d)
        acc = torch.full((tile,), MISS)
        acc_tri = torch.full((tile,), -1, dtype=torch.int32)
        for lo in range(0, K, fused1.CHUNK):
            nb = min(fused1.CHUNK, K - lo)
            if gate:
                s = sup[lo // gate:-(-(lo + nb) // gate)]
                if not cull.slab_window(o[:, None], inv[:, None], win, s[None, :, :3],
                                        s[None, :, 3:])[0].any():
                    continue
            hit, ent = cull.slab_window(o[:, None], inv[:, None], win,
                                        aabb[0:3, lo:lo + nb].T[None],
                                        aabb[3:6, lo:lo + nb].T[None])
            ent = torch.where(hit, ent, float("inf"))
            stats[0] += nb * n_live
            for i, j in enumerate(torch.nonzero(hit.any(dim=0)).reshape(-1).tolist()):
                if not (torch.minimum(acc, win) >= ent[:, j] * SKIP_SLACK).any():
                    if prefetched_skips is not None and i > 0:
                        prefetched_skips.append((t, lo + j))
                    continue
                k = lo + j
                stats[1] += 1
                stats[2] += n_live * int(real[k])
                tt = fused.mt_t_plane(tuple(o[:, a:a + 1] for a in range(3)),
                                      tuple(d[:, a:a + 1] for a in range(3)),
                                      tuple(sub[k, i][None] for i in range(9)))
                best = tt.min(dim=1).values
                ids = sub[k, 9].to(torch.int32)[None].expand_as(tt)
                best_tri = torch.where(tt == best[:, None], ids, -1).amax(dim=1)
                better = (best < MISS) & ((best < acc) | ((best == acc) & (best_tri > acc_tri)))
                acc = torch.where(better, best, acc)
                acc_tri = torch.where(better, best_tri, acc_tri)
    return stats


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100), (333, 40)])
def test_host_fused1_split_bit_equal_plain(host_lib, scene, packed_pair, wide_pair, width,
                                           pack, n, tile):
    """The split fused1 (a tile's boxes over 2, 3 and more blocks than it has
    chunks, folded through 64-bit keys) against ``plain_fused1``, flat and
    gated, for pack 1 and 2; with one split the counters are the unsplit
    kernel's, recomputed by ``_fused1_counters``. The block's lanes hold two
    rays each in groups of whole warps (``rt::fused1_shape``), one group
    over the narrow tables' sub-clusters of 32, 8 (pack 1) and 4 (pack 2)
    over the wide ones, their bests folded into the tile's after each pair;
    tiles of 100 and 40 rays leave the last lanes of every group without
    rays, and the cases include hit boxes whose block was copied while the
    previous one was swept and that the early-out then passed over."""
    table = {"narrow": (scene, packed_pair[0]), "wide": wide_pair}[width][pack - 1]
    od8 = _od8(n, tile, seed=n + 4)
    K = table.num_clusters
    ref = fused1.plain_fused1(od8, cull.box_table(table.cluster_min, table.cluster_max),
                              table.cluster_blocks, pack=pack)
    assert (ref[1] >= 0).sum() > n // 10
    n_chunks = -(-K // fused1.SPLIT_CHUNK)
    skipped = []
    for gate in (0, 16):
        for splits in (1, 2, 3, n_chunks + 2):
            t, tri, stats = _host_fused1(host_lib, od8, table, gate, pack, splits)
            assert torch.equal(t, ref[0]) and torch.equal(tri, ref[1]), (gate, splits)
            if splits == 1:
                counters = _fused1_counters(od8, table, gate, pack, skipped)
                assert stats.tolist() == counters, gate
            else:
                assert stats[1] > 0
    assert skipped  # prefetched, then passed over by the early-out


def test_split_plan():
    """One block per tile while the tiles fill the card; below that, enough
    splits of whole chunks, none without boxes; fused's plan in units of 32
    clusters."""
    assert fused1.split_plan(4096, 721) == (1, fused1.CHUNK)
    assert fused1.split_plan(64, 721, 16) == (46, 16)
    assert fused1.split_plan(256, 721, 16) == (16, 16)
    assert fused1.split_plan(64, 721, 64) == (12, 64)
    assert fused1.split_plan(8, 40) == (3, 16)
    assert fused1.split_plan(64, 721, 16, splits=5) == (5, 16)
    assert fused1.split_plan(64, 721, 16, splits=1) == (1, fused1.CHUNK)
    assert fused1.split_plan(64, 721, unit=fused.SPLIT_UNIT) == (23, 32)
    assert fused1.split_plan(256, 721, unit=fused.SPLIT_UNIT) == (12, 32)


@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_fused1_pack2_bit_equal_plain(host_lib, packed_pair, n, tile):
    """The host build's pack-2 loop against ``plain_fused1(pack=2)``, flat
    and gated; the same hits and the same swept pairs and Möller–Trumbore
    tests as its pack-1 loop over the unpacked table at C/2 (an unhit half is
    never swept), and one slab test per live ray and sub-cluster box."""
    packed, half = packed_pair
    od8 = _od8(n, tile, seed=n + 3)
    K = packed.num_clusters
    ref = fused1.plain_fused1(od8, cull.box_table(packed.cluster_min, packed.cluster_max),
                              packed.cluster_blocks, pack=2)
    assert (ref[1] >= 0).sum() > n // 10
    live = int((od8[:, 6, :] >= 0).sum())
    for gate in (0, 16):
        t, tri, stats = _host_fused1(host_lib, od8, packed, gate, 2)
        assert torch.equal(t, ref[0]) and torch.equal(tri, ref[1]), gate
        t1, tri1, stats1 = _host_fused1(host_lib, od8, half, gate, 1)
        assert torch.equal(t1, t) and torch.equal(tri1, tri)
        assert torch.equal(stats[1:], stats1[1:]) and stats[1] > 0
        if gate == 0:
            assert int(stats[0]) == K * live and int(stats1[0]) == half.num_clusters * live


def _fused_counters(od8, blocks, select, entry=None, mask=None):
    """The unsplit fused kernel's counters recomputed in PyTorch: per tile,
    the selected clusters in ascending id, each swept unless the skip test
    (entry and mask given) finds no ray that hits its box with a bound
    min(best, window) reaching the entry scaled by SKIP_SLACK, the bests
    folded as the kernel folds → [0, swept pairs, Möller–Trumbore tests]."""
    real = (blocks[:, 9, :] >= 0).sum(dim=1)
    T, _, tile = od8.shape
    stats = [0, 0, 0]
    for t in range(T):
        o, d, win = od8[t, 0:3].T, od8[t, 3:6].T, od8[t, 6]
        n_live = int((win >= 0).sum())
        acc = torch.full((tile,), MISS)
        acc_tri = torch.full((tile,), -1, dtype=torch.int32)
        for k in torch.nonzero(select[t]).reshape(-1).tolist():
            if entry is not None:
                bits = (mask[t, torch.arange(tile) // 32, k] >> (torch.arange(tile) % 32)) & 1
                if not ((bits != 0) & (torch.minimum(acc, win) >= entry[t, k] * SKIP_SLACK)).any():
                    continue
            stats[1] += 1
            stats[2] += n_live * int(real[k])
            tt = fused.mt_t_plane(tuple(o[:, a:a + 1] for a in range(3)),
                                  tuple(d[:, a:a + 1] for a in range(3)),
                                  tuple(blocks[k, i][None] for i in range(9)))
            best = tt.min(dim=1).values
            ids = blocks[k, 9].to(torch.int32)[None].expand_as(tt)
            best_tri = torch.where(tt == best[:, None], ids, -1).amax(dim=1)
            better = (best < MISS) & ((best < acc) | ((best == acc) & (best_tri > acc_tri)))
            acc = torch.where(better, best, acc)
            acc_tri = torch.where(better, best_tri, acc_tri)
    return stats


@pytest.mark.parametrize("n,tile", [(700, 64), (250, 100)])
def test_host_fused_split_bit_equal_plain(host_lib, scene, n, tile):
    """The split fused (a tile's selected clusters over 1, 2, 3 and more
    blocks than the tile selects, folded through 64-bit keys) against
    ``plain_fused``, with and without the skip test; with one split the
    counters are the unsplit kernel's, recomputed by ``_fused_counters``."""
    od8 = _od8(n, tile, seed=n + 5)
    T = od8.shape[0]
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    K = aabb.shape[1]
    blocks = scene.cluster_blocks[:K].contiguous()
    entry, mask = cull.plain_cull(od8, aabb, with_mask=True)
    select = entry < cull.MISS_ENTRY * 0.5
    words = fused.pack_words(select)
    ref = fused.plain_fused(od8, blocks, words)
    assert (ref[1] >= 0).sum() > n // 10
    many = int(select.sum(dim=1).max()) + 3
    for skip in (False, True):
        counters = _fused_counters(od8, blocks, select, *((entry, mask) if skip else ()))
        for splits in (1, 2, 3, many):
            t, tri = torch.empty_like(ref[0]), torch.empty_like(ref[1])
            stats = torch.zeros(3, dtype=torch.int64)
            host_lib.rt_host_fused_closest_hit(
                _ptr(od8), _ptr(blocks), _ptr(words), words.shape[1],
                _ptr(entry) if skip else None, _ptr(mask) if skip else None,
                T, K, blocks.shape[2], tile, splits, _ptr(t), _ptr(tri), _ptr(stats))
            assert torch.equal(t, ref[0]) and torch.equal(tri, ref[1]), (skip, splits)
            if splits == 1:
                assert stats.tolist() == counters, skip
            else:
                assert stats[1] >= counters[1] > 0
