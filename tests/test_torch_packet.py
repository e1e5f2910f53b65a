"""The port's packet intersector, Morton reorder and live-prefix helpers against the JAX package.

The same scene text is assembled by both packages (the arrays are equal,
see test_torch_scene.py) and the same rays, made with numpy, go through
both. The port writes the slab and Möller–Trumbore expression trees, the
tie rules and the sort permutations of the JAX package operation for
operation, and rounds every operation on its own, as the CUDA kernels do
(nvcc -fmad=false). XLA's CPU backend, though, contracts ``a*b + c`` into
one fused multiply-add (about a quarter of the elements of a random
``a*b - c*d`` come out different), so JAX's CPU floats are not
reproducible bit for bit by any code that rounds each operation. Hence:

- BIT-EQUAL to JAX: the safe inverse direction, the Morton keys, the
  reorder permutation, the unsort, the sort-chunk and live-prefix sizes,
  the cull's entries and hit words (no multiply-add in the slab test), and
  the packet engines' hit indices and certificate counts;
- within rtol 1e-4 of JAX: hit distances (t of a Möller–Trumbore hit
  divides two sums of products; one rounding step in each moves it by up
  to 3.3e-5 relative on the random cloud, by measurement);
- BIT-EQUAL to the port's own ``"xla"`` engine (the plain reference, as in
  the JAX package, whose tests/test_packet.py holds it bit-equal to both
  Pallas kernels): the fused and fused1 engines on the CPU;
- BIT-EQUAL to JAX's interpret-mode gated cull: the plain gated cull's
  entries and hit words; and to the flat cull: the hierarchical cull
  (``cull_hier``) of the fused engine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.models import procedural as jprocedural
from cuda_raytracer_tpu.models import scene_dsl as jdsl
from cuda_raytracer_tpu.ops import morton as jmorton
from cuda_raytracer_tpu.ops import packet_intersect as jpi
from cuda_raytracer_tpu.ops import traverse as jtraverse
from cuda_raytracer_tpu.ops.pallas import cull as jcull
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops import morton, packet_intersect, traverse
from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1
from cuda_raytracer_tpu_torch.render import wavefront


def _cloud_text(tri_count=1500, seed=11):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-5, 5, (tri_count, 1, 3))
    pts = (centres + rng.normal(scale=0.6, size=(tri_count, 3, 3))).astype(np.float32)
    lines = ["material m diffuse 0.5 0.5 0.5"]
    lines += ["triangle m " + " ".join(f"{v:.6f}" for v in p.reshape(-1)) for p in pts]
    lines += ["camera position 0 0 -20 forward 0 0 1 up 0 1 0 fov 45", "image 8 8 1 3 1"]
    return "\n".join(lines)


def build_mesh_both(text, overrides=None, cluster_tris=128, sky=False):
    """The same text assembled by both packages (port on the CPU), with the
    substitute sky when ``sky``."""
    jp = jdsl.parse_scene_text(text)
    tp = scene_dsl.parse_scene_text(text)
    if sky:
        jp.environment_map = jprocedural.substitute_envmap()
        tp.environment_map = builtin_scenes.procedural.substitute_envmap()
    js = jdsl.assemble_scene(jp, config_overrides=overrides, prefer_native_bvh=False,
                             cluster_tris=cluster_tris)
    ts = scene_dsl.assemble_scene(tp, config_overrides=overrides, prefer_native_bvh=False,
                                  cluster_tris=cluster_tris, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def cloud():
    return build_mesh_both(_cloud_text())


@pytest.fixture(scope="module")
def torus():
    return build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL), sky=True)


def _rays(n, seed=0, dead=(100, 120), windows=100):
    """Rays around the origin, unit directions, windows: open (1e30),
    ``windows`` finite ones and a dead run (-1)."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    origin[:, 1] = rng.uniform(0.1, 2.5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, 1e30, np.float32)
    t0[:windows] = rng.uniform(0.5, 4.0, windows)
    t0[dead[0]:dead[1]] = -1.0
    i0 = np.full(n, -1, np.int32)
    i0[:windows] = 0
    return origin, d, t0, i0


def _both(fn_j, fn_t, *arrays):
    return fn_j(*(jnp.asarray(a) for a in arrays)), fn_t(*(torch.from_numpy(a) for a in arrays))


def _assert_hits_match_jax(ref, got):
    """Indices and certificate exact; t within the FMA rounding (see top)."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4, atol=0)
    assert int(got[2]) == int(ref[2])


def _assert_hits_equal(ref, got):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int(got[2]) == int(ref[2])


def test_safe_inv_dir_and_sort_keys_bit_equal(torus):
    js, ts = torus
    rng = np.random.default_rng(5)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    d[::11, 2] = -1e-31
    d[::13, 0] = 3e-30
    ref, got = _both(jtraverse._safe_inv_dir, traverse._safe_inv_dir, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    alive = rng.uniform(size=4096) < 0.8
    ref = jmorton.ray_sort_keys(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
                                js.min_coord, js.inv_extent)
    got = morton.ray_sort_keys(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(alive), ts.min_coord, ts.inv_extent)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(ref))
    x = np.arange(32, dtype=np.uint32)
    np.testing.assert_array_equal(
        morton.interleave_5(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(jmorton.interleave_5(jnp.asarray(x))),
    )


def test_sort_chunk_and_live_prefix_sizes_equal(torus):
    js, ts = torus
    for rays in (333, 4096, 1 << 18, (1 << 18) + 64, 3 * (1 << 17), 1000 * 1000 * 20):
        assert wavefront.sort_chunk_size(rays) == jwavefront.sort_chunk_size(rays)
        assert wavefront.live_prefix_sizes(ts, rays) == jwavefront.live_prefix_sizes(js, rays)
        for div in (1, 3.7, 64):
            assert (wavefront.prefix_for_divisor(ts, rays, div)
                    == jwavefront.prefix_for_divisor(js, rays, div))


def _states(js, ts, n, seed):
    """The same wavefront state in both packages: rays with ~30 % dead."""
    o, d, _, _ = _rays(n, seed)
    rng = np.random.default_rng(seed + 1)
    tr = rng.uniform(size=(n, 3)).astype(np.float32)
    tr[rng.uniform(size=n) < 0.3] = 0.0
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    rid = rng.permutation(n).astype(np.int32)
    j = jwavefront.RayState(*(jnp.asarray(a) for a in (o, d, tr, col, rid)))
    t = wavefront.RayState(*(torch.from_numpy(a) for a in (o, d, tr, col, rid)))
    return j, t


@pytest.mark.parametrize("n,chunk", [(4096, None), (6000, 2000)])
def test_reorder_and_unsort_bit_equal(torus, n, chunk):
    """The reorder permutes rows exactly as JAX's (dead rays last in each
    chunk), and the unsort restores ray-id order exactly as JAX's."""
    js, ts = torus
    jstate, tstate = _states(js, ts, n, seed=n)
    ref = jwavefront.reorder_rays(js, jstate, chunk_size=chunk)
    got = wavefront.reorder_rays(ts, tstate, chunk_size=chunk)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    cs = chunk or n
    dead = ~torch.any(got.transmitted != 0, dim=-1).reshape(-1, cs)
    assert torch.equal(dead, dead.sort(dim=1, stable=True).values)  # dead last
    ids = np.arange(n, dtype=np.int32)
    np.random.default_rng(1).shuffle(ids.reshape(-1, wavefront.sort_chunk_size(n)).T)
    col = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    ref = jwavefront._unsort_by_ray_id(jnp.asarray(col), jnp.asarray(ids))
    got = wavefront._unsort_by_ray_id(torch.from_numpy(col), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("scene_name,n,tile,cap", [
    ("cloud", 333, 64, 64),
    ("cloud", 256, 32, 1),  # cap 1: the certificate must fire the same way
    ("torus", 333, 32, 64),
    ("torus", 512, 64, 2),
])
def test_xla_engine_bit_equal_jax(cloud, torus, scene_name, n, tile, cap):
    js, ts = {"cloud": cloud, "torus": torus}[scene_name]
    o, d, t0, i0 = _rays(n, seed=n + tile)
    cap = min(cap, ts.num_clusters)
    ref = jpi.closest_hit_packet(js, *(jnp.asarray(a) for a in (o, d, t0, i0)),
                                 tile=tile, cap=cap, backend="xla")
    got = packet_intersect.closest_hit_packet(
        ts, *(torch.from_numpy(a) for a in (o, d, t0, i0)), tile=tile, cap=cap,
        backend="xla",
    )
    _assert_hits_match_jax(ref, got)
    if cap == 1:
        assert int(got[2]) > 0


def test_plain_cull_bit_equal_jax_interpret(cloud):
    """The cull's plain version (entry and per-ray hit words) against the
    Pallas kernel in interpret mode, at an unaligned ray count."""
    js, ts = cloud
    tile, n = 64, 200
    o, d, t0, _ = _rays(n, seed=3)
    op, dp, wp = packet_intersect._pad_rays(*(torch.from_numpy(a) for a in (o, d, t0)), tile)
    od8 = cull.make_od8(op, dp, wp, tile)
    aabb = cull.box_table(ts.cluster_min, ts.cluster_max)
    j_od8 = jnp.pad(jnp.asarray(od8.numpy()), ((0, 1), (0, 0), (0, 128 - tile)))
    e_ref, m_ref = jcull.cull_tiles(j_od8, jnp.asarray(aabb.numpy()), tile=tile,
                                    interpret=True, with_mask=True)
    entry, mask = cull.plain_cull(od8, aabb, with_mask=True)
    np.testing.assert_array_equal(entry.numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(m_ref))
    # The wrapper on CPU tensors is the plain version and launches nothing.
    launches = cull.LAUNCHES
    assert torch.equal(cull.cull_tiles(od8, aabb), entry)
    assert cull.LAUNCHES == launches


@pytest.mark.parametrize("backend,kw", [
    ("fused", {}),
    ("fused", dict(skip=True)),
    ("fused1", {}),
])
@pytest.mark.parametrize("scene_name,tile", [("cloud", 64), ("torus", 32)])
def test_kernel_engines_bit_equal_xla(cloud, torus, scene_name, tile, backend, kw):
    """The fused and fused1 engines (their kernels' plain versions on the
    CPU) bit-equal to the xla engine, which matches JAX's above."""
    _, ts = {"cloud": cloud, "torus": torus}[scene_name]
    rays = [torch.from_numpy(a) for a in _rays(333, seed=7)]
    ref = packet_intersect.closest_hit_packet(ts, *rays, tile=tile, cap=ts.num_clusters,
                                              backend="xla")
    assert int(ref[2]) == 0  # uncapped: the xla engine is exact
    launches = (cull.LAUNCHES, fused.LAUNCHES, fused1.LAUNCHES)
    got = packet_intersect.closest_hit_packet(ts, *rays, tile=tile, backend=backend, **kw)
    _assert_hits_equal(ref, got)
    assert (cull.LAUNCHES, fused.LAUNCHES, fused1.LAUNCHES) == launches  # plain on the CPU


@pytest.mark.parametrize("backend,shards", [("fused", 3), ("fused1", 2)])
@pytest.mark.parametrize("scene_name,tile", [("cloud", 64), ("torus", 32)])
def test_shard_merge_bit_equal(cloud, torus, scene_name, tile, backend, shards):
    """The cluster table cut into ranges, each range's kernel result (the
    plain version on the CPU) folded with ``_merge``, equals the kernel over
    the whole table bit for bit: the merge is the kernels' own fold."""
    _, ts = {"cloud": cloud, "torus": torus}[scene_name]
    o, d, t0, _ = (torch.from_numpy(a) for a in _rays(333, seed=7))
    od8 = cull.make_od8(*packet_intersect._pad_rays(o, d, t0, tile), tile)
    K = ts.num_clusters

    def run(lo, hi):
        aabb = cull.box_table(ts.cluster_min[lo:hi], ts.cluster_max[lo:hi])
        blocks = ts.cluster_blocks[lo:hi].contiguous()
        if backend == "fused1":
            return fused1.fused1_closest_hit(od8, aabb, blocks)
        words = fused.pack_words(cull.cull_tiles(od8, aabb) < cull.MISS_ENTRY * 0.5)
        return fused.fused_closest_hit(od8, blocks, words)

    whole = run(0, K)
    merged = None
    for s in range(shards):
        merged = packet_intersect._merge(merged, *run(K * s // shards, K * (s + 1) // shards))
    assert torch.equal(merged[0], whole[0]) and torch.equal(merged[1], whole[1])
    assert (whole[1] >= 0).any()


def test_fused1_gate_and_supers(cloud):
    """The super boxes bound their boxes, an all-padding group keeps the far
    point box, and the plain fused1 equals the plain cull + fused sweep."""
    _, ts = cloud
    K = ts.num_clusters
    pad = torch.full((3, 3), 1e17)
    box_min = torch.cat([ts.cluster_min, pad])
    box_max = torch.cat([ts.cluster_max, pad])
    sup = fused1.shard_supers(box_min, box_max, 4)
    assert sup.shape == (-(-(K + 3) // 4), 6)
    for s in range(K // 4):
        assert torch.all(sup[s, :3] <= box_min[4 * s:4 * s + 4].amin(dim=0))
        assert torch.all(sup[s, 3:] >= box_max[4 * s:4 * s + 4].amax(dim=0))
    if (K + 3) % 4 == 3:
        assert torch.all(sup[-1] == 1e17)
    o, d, t0, _ = _rays(256, seed=9)
    od8 = cull.make_od8(*(torch.from_numpy(a) for a in (o, d, t0)), 64)
    aabb = cull.box_table(ts.cluster_min, ts.cluster_max)
    blocks = ts.cluster_blocks[:K].contiguous()
    ref = fused.plain_fused(od8, blocks, fused.pack_words(cull.plain_cull(od8, aabb) < 5e29))
    got = fused1.fused1_closest_hit(od8, aabb, blocks)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("backend,hier", [("fused1", 0), ("fused", 0), ("fused", 2)])
def test_scene_tables_built_once_hits_unchanged(torus, backend, hier):
    """The box, super-box and gated-cull tables are built once per scene
    (``scene.derived``): a second bounce, or the same scene under another
    config, reuses them; the closest hit is bit-identical to one through
    freshly built tables; a replaced cluster table is rebuilt."""
    _, ts = torus
    ts = ts.with_config(cull_hier=hier)
    rays = [torch.from_numpy(a) for a in _rays(333, seed=11)]
    ref = packet_intersect.closest_hit_packet(ts, *rays, tile=32, cap=ts.num_clusters,
                                              backend="xla")
    first = packet_intersect.closest_hit_packet(ts, *rays, tile=32, backend=backend)
    _assert_hits_equal(ref, first)
    table = packet_intersect.box_table(ts)
    assert packet_intersect.box_table(ts.with_config(width=8)) is table
    assert torch.equal(table, cull.box_table(ts.cluster_min, ts.cluster_max))
    assert torch.equal(packet_intersect.super_table(ts, 16),
                       fused1.shard_supers(ts.cluster_min, ts.cluster_max, 16))
    _assert_hits_equal(first, packet_intersect.closest_hit_packet(ts, *rays, tile=32,
                                                                  backend=backend))
    moved = ts.replace(cluster_min=ts.cluster_min - 0.5)
    assert not torch.equal(packet_intersect.box_table(moved), table)
    assert torch.equal(packet_intersect.box_table(moved),
                       cull.box_table(moved.cluster_min, moved.cluster_max))


def test_unported_options_raise(cloud):
    _, ts = cloud
    o, d, t0, i0 = (torch.from_numpy(a) for a in _rays(256))
    # The pallas engine runs (its sweep's plain version on the CPU), equal
    # to the xla engine while its pair budget holds; the JAX package's
    # interpret-mode names are unknown to the port.
    xla = packet_intersect.closest_hit_packet(ts, o, d, t0, i0, cap=ts.num_clusters)
    for two_round in (False, True):
        got = packet_intersect.closest_hit_packet(ts, o, d, t0, i0, cap=ts.num_clusters,
                                                  backend="pallas", two_round=two_round)
        _assert_hits_equal(xla, got)
    for name in ("pallas_interpret", "fused2"):
        with pytest.raises(ValueError, match="unknown packet backend"):
            packet_intersect.closest_hit_packet(ts, o, d, t0, i0, backend=name)
    # cull_hier on the fused engine runs (too few boxes here to gate: the
    # flat cull), bit-equal to the flat engine.
    ref = packet_intersect.closest_hit_packet(ts, o, d, t0, i0, backend="fused")
    got = packet_intersect.closest_hit_packet(ts.with_config(cull_hier=16), o, d, t0, i0,
                                              backend="fused")
    _assert_hits_equal(ref, got)
    # A paired sub-cluster table runs through fused1 (and "auto"), equal to
    # the unpacked table cut at C/2; the engines that index blocks by box
    # raise.
    _, packed = build_mesh_both(_cloud_text(), dict(cluster_pack=2), cluster_tris=256)
    ref = packet_intersect.closest_hit_packet(ts, o, d, t0, i0, backend="fused1")
    for name in ("fused1", "auto"):
        _assert_hits_equal(ref, packet_intersect.closest_hit_packet(packed, o, d, t0, i0,
                                                                    backend=name))
    for name in ("xla", "fused", "pallas"):
        with pytest.raises(ValueError, match="cluster_pack"):
            packet_intersect.closest_hit_packet(packed, o, d, t0, i0, backend=name)
    assert packet_intersect.resolve_backend("auto", torch.device("cpu")) == "xla"
    assert packet_intersect.resolve_backend("auto", torch.device("cuda")) == "fused"


@pytest.mark.parametrize("skip", [False, True])
def test_fused_two_round_bit_equal_xla_and_jax(cloud, skip):
    """The fused engine's front-to-back two-round sweep (round 1: each
    tile's nearest cluster) is exact: bit-equal to the xla engine, and its
    hits match JAX's fused two-round engine in interpret mode."""
    js, ts = cloud
    o, d, t0, i0 = _rays(300, seed=13)
    rays = [torch.from_numpy(a) for a in (o, d, t0, i0)]
    xla = packet_intersect.closest_hit_packet(ts, *rays, tile=64, cap=ts.num_clusters)
    got = packet_intersect.closest_hit_packet(ts, *rays, tile=64, backend="fused",
                                              two_round=True, skip=skip)
    _assert_hits_equal(xla, got)
    ref = jpi.closest_hit_packet(js, *(jnp.asarray(a) for a in (o, d, t0, i0)), tile=64,
                                 cap=js.num_clusters, backend="fused_interpret",
                                 two_round=True, skip=skip)
    _assert_hits_match_jax(ref, got)


def _gates(live):
    """(T, n_chunks) bool → flat (T * Wg,) int32 gate words, built in int64
    and wrapped as the JAX test builds them."""
    T, n = live.shape
    Wg = -(-n // 32)
    bits = np.zeros((T, Wg * 32), np.int64)
    bits[:, :n] = live
    words = (bits.reshape(T, Wg, 32) << np.arange(32)).sum(axis=2)
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32).reshape(-1)


@pytest.mark.parametrize("table", ["cloud", "wide"])
def test_plain_cull_gated_bit_equal_jax_interpret(table):
    """The gated cull's plain version against the Pallas kernel in interpret
    mode, entries and hit words, with all-ones gates, with the real gates
    (chunk live iff some box of it is hit) and with half of those cleared:
    on the 4000-triangle cloud's cluster table (mirroring
    tests/test_packet.py) and on a 4224-box table of 33 chunks, whose gate
    words set bit 31."""
    tile, n = 64, 256
    o, d, t0, _ = _rays(n, seed=21, dead=(0, 0))
    t0[::9] = -1.0
    if table == "cloud":
        _, ts = build_mesh_both(_cloud_text(4000), cluster_tris=32)
        box_min, box_max = ts.cluster_min, ts.cluster_max
    else:
        rng = np.random.default_rng(5)
        centre = rng.uniform(-6, 6, (33 * 128, 3)).astype(np.float32)
        half = rng.uniform(0.02, 0.4, (33 * 128, 3)).astype(np.float32)
        box_min, box_max = torch.from_numpy(centre - half), torch.from_numpy(centre + half)
    K = box_min.shape[0]
    Kp = -(-K // cull.GATE_CHUNK) * cull.GATE_CHUNK
    far = torch.full((Kp - K, 3), 1e17)
    aabb = cull.box_table(torch.cat([box_min, far]), torch.cat([box_max, far]))
    od8 = cull.make_od8(*(torch.from_numpy(a) for a in (o, d, t0)), tile)
    T, nch = od8.shape[0], Kp // cull.GATE_CHUNK
    j_od8 = jnp.pad(jnp.asarray(od8.numpy()), ((0, 1), (0, 0), (0, 128 - tile)))
    j_aabb = jnp.asarray(aabb.numpy())
    e_ref, m_ref = jcull.cull_tiles(j_od8, j_aabb, tile=tile, interpret=True, with_mask=True)
    live = np.asarray(e_ref < jcull.MISS_ENTRY * 0.5).reshape(T, nch, -1).any(axis=2)
    assert live.any()
    # A gate that also clears live chunks (every other one) is no longer
    # conservative, but the gated function is defined for any gate words.
    checker = live & (np.add.outer(np.arange(T), np.arange(nch)) % 2 == 0)
    launches = cull.LAUNCHES_GATED
    for conservative, gate in ((True, np.ones_like(live)), (True, live), (False, checker)):
        gates = _gates(gate)
        j_e, j_m = jcull.cull_tiles_gated(j_od8, j_aabb, jnp.asarray(gates), tile=tile,
                                          interpret=True, with_mask=True)
        if conservative:  # bit-equal to the flat cull
            np.testing.assert_array_equal(np.asarray(j_e), np.asarray(e_ref))
        else:  # the cleared live chunks read as misses
            assert (np.asarray(j_e) == jcull.MISS_ENTRY).sum() > (e_ref == jcull.MISS_ENTRY).sum()
        got = cull.cull_tiles_gated(od8, aabb, torch.from_numpy(gates), with_mask=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_e))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(j_m))
        # The port builds the same words from the same bits.
        port_gates = cull.pack_bits(cull.unpack_gates(torch.from_numpy(gates), T, nch)[:, :, None])
        assert np.array_equal(port_gates.reshape(-1).numpy(), gates)
    if table == "wide":
        assert (_gates(live) < 0).any()  # bit 31 of some word is set
    assert cull.LAUNCHES_GATED == launches  # plain on the CPU
    with pytest.raises(ValueError, match="% 128"):
        cull.cull_tiles_gated(od8, aabb[:, :-1].contiguous(), torch.from_numpy(gates))
    with pytest.raises(ValueError, match="gates"):
        cull.cull_tiles_gated(od8, aabb, torch.from_numpy(gates)[:-1])


@pytest.fixture(scope="module")
def cloud_hier():
    """6000 triangles in clusters of 32, two sub-boxes each: K·S >= 256
    boxes, so cull_hier = 16 gates chunks (GS = 32)."""
    return build_mesh_both(_cloud_text(6000), cluster_tris=32,
                           overrides=dict(cull_split=2, cull_hier=16))


@pytest.mark.parametrize("skip", [False, True])
def test_hier_cull_bit_equal_flat_and_matches_jax(cloud_hier, skip):
    js, ts = cloud_hier
    assert ts.cluster_min.shape[0] >= 2 * cull.GATE_CHUNK
    o, d, t0, i0 = _rays(384, seed=4)
    rays = [torch.from_numpy(a) for a in (o, d, t0, i0)]
    got = packet_intersect.closest_hit_packet(ts, *rays, tile=64, backend="fused", skip=skip)
    flat = packet_intersect.closest_hit_packet(ts.with_config(cull_hier=0), *rays, tile=64,
                                               backend="fused", skip=skip)
    _assert_hits_equal(flat, got)
    assert int((got[1] >= 0).sum()) > 100
    ref = jpi.closest_hit_packet(js, *(jnp.asarray(a) for a in (o, d, t0, i0)), tile=64,
                                 cap=js.num_clusters, backend="fused_interpret", skip=skip)
    _assert_hits_match_jax(ref, got)
    with pytest.raises(ValueError, match="must divide 128"):
        packet_intersect.closest_hit_packet(ts.with_config(cull_hier=3), *rays, tile=64,
                                            backend="fused")


def _jax_super_table(js, GS):
    """The JAX package's pre-pass tables (``closest_hit_packet``'s
    hierarchical cull, written out in jnp): the (8, Kp) box table padded with
    far point boxes, and the (8, Kp / GS) tight super boxes over GS
    consecutive boxes."""
    KS = js.cluster_min.shape[0]
    Kp = -(-KS // jcull.GATE_CHUNK) * jcull.GATE_CHUNK
    pad = jnp.full((3, Kp - KS), 1e17, jnp.float32)
    aabb_p = jnp.concatenate([jnp.concatenate([js.cluster_min.T, pad], axis=1),
                              jnp.concatenate([js.cluster_max.T, pad], axis=1),
                              jnp.zeros((2, Kp), jnp.float32)])
    smin, smax = aabb_p[0:3].T, aabb_p[3:6].T
    is_pad = smin[:, 0] >= 1e16
    gmin = jnp.where(is_pad[:, None], jnp.inf, smin).reshape(-1, GS, 3).min(axis=1)
    gmax = jnp.where(is_pad[:, None], -jnp.inf, smax).reshape(-1, GS, 3).max(axis=1)
    empty = jnp.all(is_pad.reshape(-1, GS), axis=1)[:, None]
    gmin, gmax = jnp.where(empty, 1e17, gmin), jnp.where(empty, 1e17, gmax)
    sup = jnp.concatenate([gmin.T, gmax.T, jnp.zeros((2, gmin.shape[0]), jnp.float32)])
    return aabb_p, sup


@pytest.mark.parametrize("with_mask", [False, True])
def test_hier_cull_one_launch_matches_jax_gated(cloud_hier, with_mask):
    """The fused engine's hierarchical cull (``_cull``: the one-launch
    ``cull.cull_tiles_hier``, its plain version on the CPU) BIT-EQUAL to the
    JAX ``cull_tiles_gated`` in interpret mode behind the JAX package's own
    pre-pass (its flat ``cull_tiles`` of the super boxes in interpret mode,
    the any over each chunk's supers, the gate words), on coherent ray tiles
    that leave some chunks gated off; and to the flat cull."""
    js, ts = cloud_hier
    S, tile = 2, 64
    rng = np.random.default_rng(8)
    T = 6
    o = np.repeat(rng.uniform(-6, 6, (T, 3)), tile, axis=0) + rng.normal(0, 0.05, (T * tile, 3))
    d = np.repeat(rng.normal(size=(T, 3)), tile, axis=0) + rng.normal(0, 0.05, (T * tile, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.full(T * tile, 1e30)
    w[::7] = rng.uniform(1.0, 8.0, w[::7].shape)
    w[5:9] = -1.0
    od8 = cull.make_od8(*(torch.from_numpy(a.astype(np.float32)) for a in (o, d, w)), tile)
    KS = ts.cluster_min.shape[0]
    launches = cull.LAUNCHES_GATED
    got = packet_intersect._cull(ts, od8, S, with_mask)
    assert cull.LAUNCHES_GATED == launches  # the plain version on the CPU
    aabb_p, sup = _jax_super_table(js, 16 * S)
    n_chunks = aabb_p.shape[1] // jcull.GATE_CHUNK
    j_od8 = jnp.pad(jnp.asarray(od8.numpy()), ((0, 1), (0, 0), (0, 128 - tile)))
    hit_sup = jcull.cull_tiles(j_od8, sup, tile=tile, interpret=True)[:T] < jcull.MISS_ENTRY * 0.5
    gate = np.asarray(hit_sup).reshape(T, n_chunks, -1).any(axis=2)
    assert gate.any() and not gate.all()
    gates = _gates(gate)
    ref = jcull.cull_tiles_gated(j_od8, aabb_p, jnp.asarray(gates), tile=tile,
                                 interpret=True, with_mask=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0])[:T, :KS])
    flat = cull.plain_cull(od8, cull.box_table(ts.cluster_min, ts.cluster_max), with_mask=True)
    assert torch.equal(got[0], flat[0])
    if with_mask:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1])[:T, :, :KS])
        assert torch.equal(got[1], flat[1])
    else:
        assert got[1] is None
    # The port's own pre-pass gives the JAX words.
    gates_port = packet_intersect.hier_gates(od8, cull.box_table(
        torch.from_numpy(np.array(sup[0:3].T)), torch.from_numpy(np.array(sup[3:6].T))),
        n_chunks)
    np.testing.assert_array_equal(gates_port.numpy(), gates)
