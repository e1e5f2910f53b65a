"""The packet kernels (cull, gated cull, fused, fused1, the pair sweep) on the GPU, against their plain PyTorch versions.

Marked ``cuda``: skipped on a machine without a GPU. On the GPU machine,
which has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py -q

Each kernel is held BIT-EQUAL to its plain version on real wavefront states
of the small torus at 32×32 (coherent primary rays and Morton-sorted
bounced ones), through ``intersector="packet"`` unless a test names
another: "auto" on the card walks the BVH, and a render through it launches
the walk and no packet kernel and gives the walk's bits. A two-pass render
(packet backend "auto": fused1 for its 10-rays-per-pixel
pass, the pass regime, and cull + fused for its 2-rays-per-pixel pass) is
held to the agreement gate against the same render with the xla engine, and
bit-equal to it through fused1 alone. The
gated cull is held bit-equal to its plain version with all-ones, real and
all-zero gates and in its one-launch form (gates from the super boxes), and
the hierarchical cull engine to the flat one. The pair sweep is held
bit-equal to its plain version (tile-major and shuffled pairs, a budget that
holds and one that overflows, at the kernel's range count and at 1, 7, one
per pair and more ranges than pairs), the "pallas" engine to
the "fused" one, and a differentiable render through each engine launches
its closest-hit kernels in the forward pass and none in the backward pass.
fused1's block body is held bit-equal at 1 row to 2^18 rows with a ragged
last tile, pack 1 and 2, flat and gated, at every split it is run at, its
unsplit counters equal to the host build's. The pack-2 fused1 kernel
(paired sub-cluster tables, ``cluster_pack=2``) is
held bit-equal to its plain version (flat, gated, two block-aligned shards)
and to the pack-1 kernel over the table cut at C/2, and a packed render
launches it alone and equals the unpacked render at C/2 bit for bit. fused1
and fused split over several blocks per tile are held bit-equal to their
plain versions (fused with and without its skip test),
and the bounce kernel to the torch shading under the shade gate; a forward
render launches the bounce kernel and a graph-building pass does not. Given
their counters (``shade.dielectric``, ``rays.live_tail``) the bounce and
set-up kernels keep their bits and count what their plain versions count,
and a recorded glass render keeps its framebuffer.
The BVH walk kernel (``intersector="bvh"``) and the "cullhit" key kernel
are held bit-equal to their plain versions (dead rays, a ragged last block,
the packed rows' strided columns; the walk also at 1, 31, 33 and 657 rays
at 1, 5 and 32 rays a warp and the kernel's pick, one launch a call), a BVH render and a cullhit
render launch their kernels, and an unsupported input on the card raises
(a tree deeper than the walk's stack among them). Both key kernels (Morton
and cullhit) are held bit-equal at 1, 255, 256, 257, 4,096 and 2^18 rows at
``cull_split`` 1 and 2, the cullhit key also over a table staged in steps
(6,000 boxes), and their live counts right on back-to-back launches without
a reset, on the current stream and on a second one. The camera kernel's
rows are held bit-equal to its plain version (a whole pass, an unaligned
block, one row, ids just below 2^31, a pass seed above 2^31); a forward
render launches it once a block and the PCG draw kernel never, and gives
the bits of blocks traced from ``make_initial_state``, while a
differentiable render draws through the PCG draw kernel and launches no
camera kernel.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.ops import intersect, traverse
from cuda_raytracer_tpu_torch.ops.kernels import cull, fused, fused1, rays, shade, sweep
from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
from cuda_raytracer_tpu_torch.render import diff, packed, pipeline, wavefront

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _scene(device, name="torus", **overrides):
    """The small torus at 32×32 through the packet intersector unless
    ``overrides`` name another ("auto" on the card walks the BVH)."""
    parsed = builtin_scenes.parse_mesh_scene(name, builtin_scenes.SMALL)
    cfg = {"width": 32, "height": 32, "intersector": "packet", **overrides}
    return scene_dsl.assemble_scene(parsed, config_overrides=cfg, device=device)


def _states(scene, rpp=4, bounces=2):
    """The wavefront entering bounces 0..bounces-1, sorted after each."""
    ids = torch.arange(32 * 32 * rpp, dtype=torch.int32, device=scene.device)
    state = wavefront.make_initial_state(scene, ids, rpp, 3)
    states = [state]
    for b in range(bounces - 1):
        state, _ = wavefront.process_rays(scene, state, 3, b)
        state = wavefront.reorder_rays(scene, state)
        states.append(state)
    return states


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_kernels_bit_equal_plain(cuda, name):
    scene = _scene(cuda, name)
    K = scene.num_clusters
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    blocks = scene.cluster_blocks[:K].contiguous()
    for state in _states(scene):
        alive = torch.any(state.transmitted != 0, dim=-1)
        window = torch.where(alive, 1e30, -1.0)
        rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                          window[:-7], 64)  # unaligned count
        od8 = cull.make_od8(*rays, 64)
        before = (cull.LAUNCHES, fused.LAUNCHES, fused1.LAUNCHES)
        entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
        entry_ref, mask_ref = cull.plain_cull(od8, aabb, with_mask=True)
        assert torch.equal(entry, entry_ref) and torch.equal(mask, mask_ref)
        assert torch.equal(cull.cull_tiles(od8, aabb), entry_ref)
        words = fused.pack_words(entry_ref < cull.MISS_ENTRY * 0.5)
        ref = fused.plain_fused(od8, blocks, words)
        for skip in (False, True):
            got = fused.fused_closest_hit(od8, blocks, words,
                                          entry if skip else None, mask if skip else None)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for gate in (0, 16):
            sup = fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate) if gate else None
            got = fused1.fused1_closest_hit(od8, aabb, blocks, sup, gate)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        torch.cuda.synchronize()
        assert (cull.LAUNCHES, fused.LAUNCHES, fused1.LAUNCHES) == (
            before[0] + 2, before[1] + 2, before[2] + 2)
        assert (ref[1] >= 0).any()


def test_engines_bit_equal_xla(cuda):
    scene = _scene(cuda)
    state = _states(scene)[1]
    alive = torch.any(state.transmitted != 0, dim=-1)
    t = torch.where(alive, 1e30, -1.0)
    index = torch.full_like(alive, -1, dtype=torch.int32)
    args = (scene, state.origin, state.direction, t, index)
    ref = packet_intersect.closest_hit_packet(*args, tile=64, cap=scene.num_clusters,
                                              backend="xla")
    for backend, kw in (("fused", {}), ("fused", dict(skip=True)), ("fused1", {})):
        got = packet_intersect.closest_hit_packet(*args, tile=64, backend=backend, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (backend, kw)


def test_render_goes_through_kernels_and_matches_xla(cuda):
    scene = _scene(cuda, rays_per_pixel=12, bounces=4, max_rays_per_pixel_per_pass=10)
    counts = lambda: (cull.LAUNCHES, fused.LAUNCHES, fused1.LAUNCHES, shade.LAUNCHES)
    before = counts()
    # Passes of 10 and 2: the first through fused1 (the pass regime), the
    # second through cull + fused.
    fb = pipeline.render_framebuffer(scene)
    after = counts()
    assert all(a > b for a, b in zip(after[:3], before[:3])) and after[3] == before[3]
    assert pipeline._regime_scene(scene, 10).config.packet_backend == "fused1"
    assert pipeline._regime_scene(scene, 2) is scene
    fused1_fb = pipeline.render_framebuffer(scene.with_config(packet_backend="fused1"))
    assert counts()[2] > after[2] and counts()[:2] == after[:2]  # fused1 alone
    assert torch.equal(fused1_fb, fb)
    after = counts()
    plain = pipeline.render_framebuffer(scene.with_config(packet_backend="xla"))
    assert counts() == after  # the xla engine launches no kernel
    torch.cuda.synchronize()
    assert torch.isfinite(fb).all()
    diff = (fb - plain).abs().amax(dim=1)
    assert float((diff < 1e-3).float().mean()) >= 0.999



def test_gated_cull_bit_equal_plain(cuda):
    """A torus cut into ~580 sub-boxes (five gate chunks): the gated kernel
    against its plain version with all-ones, real and all-zero gates, with
    and without hit words; its one-launch form (gates computed from the
    super boxes) against ``plain_cull_hier`` and the flat cull; the
    hierarchical engine against the flat one, launching the gated kernel
    and no flat cull of the super boxes."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    scene = scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=32, height=32, cull_split=2),
        cluster_tris=32, device=cuda)
    KS = scene.cluster_min.shape[0]
    assert KS >= 2 * cull.GATE_CHUNK
    Kp = -(-KS // cull.GATE_CHUNK) * cull.GATE_CHUNK
    far = torch.full((Kp - KS, 3), 1e17, device=cuda)
    aabb = cull.box_table(torch.cat([scene.cluster_min, far]),
                          torch.cat([scene.cluster_max, far]))
    for state in _states(scene):
        alive = torch.any(state.transmitted != 0, dim=-1)
        window = torch.where(alive, 1e30, -1.0)
        rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                          window[:-7], 64)
        od8 = cull.make_od8(*rays, 64)
        T = od8.shape[0]
        flat = cull.plain_cull(od8, aabb, with_mask=True)
        live = (flat[0] < cull.MISS_ENTRY * 0.5).reshape(T, -1, cull.GATE_CHUNK).any(dim=2)
        before = cull.LAUNCHES_GATED
        for gate in (torch.ones_like(live), live, torch.zeros_like(live)):
            gates = cull.pack_bits(gate[:, :, None]).reshape(-1)
            ref = cull.plain_cull_gated(od8, aabb, gates, with_mask=True)
            got = cull.cull_tiles_gated(od8, aabb, gates, with_mask=True)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            assert torch.equal(cull.cull_tiles_gated(od8, aabb, gates), ref[0])
            if gate.any():
                assert torch.equal(ref[0], flat[0]) and torch.equal(ref[1], flat[1])
        _, sup = packet_intersect.hier_tables(scene.cluster_min, scene.cluster_max, 32)
        ref = cull.plain_cull_hier(od8, aabb, sup, with_mask=True)
        assert torch.equal(ref[0], flat[0]) and torch.equal(ref[1], flat[1])
        got = cull.cull_tiles_hier(od8, aabb, sup, with_mask=True)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(cull.cull_tiles_hier(od8, aabb, sup), ref[0])
        torch.cuda.synchronize()
        assert cull.LAUNCHES_GATED == before + 8
    t = torch.where(alive, 1e30, -1.0)
    index = torch.full_like(alive, -1, dtype=torch.int32)
    for skip in (False, True):
        args = (state.origin, state.direction, t, index)
        ref = packet_intersect.closest_hit_packet(scene, *args, backend="fused", skip=skip)
        flat_launches, gated_launches = cull.LAUNCHES, cull.LAUNCHES_GATED
        got = packet_intersect.closest_hit_packet(scene.with_config(cull_hier=16), *args,
                                                  backend="fused", skip=skip)
        assert (cull.LAUNCHES, cull.LAUNCHES_GATED) == (flat_launches, gated_launches + 1)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("width", [None, 30])
def test_sweep_kernel_bit_equal_plain(cuda, width):
    """The sweep at the default cluster width and at 30, no multiple of 4
    (triangle by triangle, its second staging buffer not 16-byte aligned)."""
    if width is None:
        scene = _scene(cuda)
    else:
        parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
        scene = scene_dsl.assemble_scene(parsed, config_overrides=dict(width=32, height=32),
                                         cluster_tris=width, device=cuda)
        assert scene.cluster_tris == width
    K = scene.num_clusters
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    for state in _states(scene):
        alive = torch.any(state.transmitted != 0, dim=-1)
        window = torch.where(alive, 1e30, -1.0)
        rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                          window[:-7], 64)
        od8 = cull.make_od8(*rays, 64)
        T = od8.shape[0]
        rays_tiles = sweep.make_rays_tiles(rays[0], rays[1], 64)
        select = cull.plain_cull(od8, aabb) < packet_intersect.HIT_THRESH
        for P in (T * K, T):  # a budget that holds, one that overflows
            pairs, total, _ = packet_intersect.extract_pairs(select, P)
            k = int(total)
            shuffled = pairs.clone()
            shuffled[:, :k] = pairs[:, torch.randperm(k, device=cuda)]
            ref = sweep.plain_sweep(rays_tiles, scene.cluster_blocks, pairs, total, 64)
            before = sweep.LAUNCHES
            # The kernel's range count, one range, ranges that cut a tile's
            # run of pairs, one range per pair and more ranges than pairs.
            counts = (None, 1, 7, max(k, 1), P + 3)
            for pair_list in (pairs, shuffled):
                for ranges in counts:
                    got = sweep.sweep_pairs(rays_tiles, scene.cluster_blocks, pair_list, total,
                                            64, ranges=ranges)
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), ranges
            torch.cuda.synchronize()
            assert sweep.LAUNCHES == before + 2 * len(counts) and (ref[1] >= 0).any()


def test_pallas_engine_bit_equal_fused(cuda):
    scene = _scene(cuda, name="glass_torus")
    state = _states(scene)[1]
    alive = torch.any(state.transmitted != 0, dim=-1)
    t = torch.where(alive, 1e30, -1.0)
    index = torch.full_like(alive, -1, dtype=torch.int32)
    args = (scene, state.origin, state.direction, t, index)
    ref = packet_intersect.closest_hit_packet(*args, tile=64, backend="fused")
    for two_round in (False, True):
        got = packet_intersect.closest_hit_packet(*args, tile=64, cap=scene.num_clusters,
                                                  backend="pallas", two_round=two_round)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and int(got[2]) == 0


@pytest.mark.parametrize("backend,kernels", [("auto", ("cull", "fused")),
                                             ("pallas", ("cull", "sweep"))])
def test_backward_launches_no_closest_hit_kernel(cuda, backend, kernels):
    scene = _scene(cuda, packet_backend=backend)
    modules = {"cull": cull, "fused": fused, "fused1": fused1, "sweep": sweep}
    counts = lambda: {name: m.LAUNCHES for name, m in modules.items()}
    before = counts()
    params = diff.make_leaves(diff.split_params(scene)[0])
    loss = diff.render_radiance(params, scene, 0, 2, 4).square().mean()
    forward = counts()
    loss.backward()
    torch.cuda.synchronize()
    assert counts() == forward
    assert all(forward[k] > before[k] for k in kernels)
    assert all(forward[k] == before[k] for k in modules if k not in kernels)
    for p in diff.param_leaves(params):
        assert p.grad is None or torch.isfinite(p.grad).all()
    assert params.materials.diffuse_albedo.grad.abs().sum() > 0


def _packed_pair(device, **overrides):
    """The torus in sub-clusters of 32: packed two to a 64-lane block, and
    unpacked."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (72, 48))
    cfg = dict(width=32, height=32, intersector="packet", **overrides)
    packed = scene_dsl.assemble_scene(parsed, config_overrides=dict(cfg, cluster_pack=2),
                                      cluster_tris=64, device=device)
    half = scene_dsl.assemble_scene(parsed, config_overrides=cfg, cluster_tris=32,
                                    device=device)
    return packed, half


def test_pack2_kernel_bit_equal_plain(cuda):
    packed, half = _packed_pair(cuda)
    K = packed.num_clusters
    assert K > 2 * fused1.CHUNK
    cmin, cmax = packed.cluster_min, packed.cluster_max
    blocks = packed.cluster_blocks[:K // 2].contiguous()
    hmin, hmax = half.cluster_min, half.cluster_max
    for state in _states(packed):
        alive = torch.any(state.transmitted != 0, dim=-1)
        window = torch.where(alive, 1e30, -1.0)
        rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                          window[:-7], 64)
        od8 = cull.make_od8(*rays, 64)
        ref = fused1.plain_fused1(od8, cull.box_table(cmin, cmax), blocks, pack=2)
        before = (fused1.LAUNCHES, fused1.LAUNCHES_PACK2)
        for gate in (0, 16):
            def run(lo, hi):
                return fused1.fused1_closest_hit(
                    od8, cull.box_table(cmin[lo:hi], cmax[lo:hi]),
                    blocks[lo // 2:hi // 2].contiguous(),
                    fused1.shard_supers(cmin[lo:hi], cmax[lo:hi], gate) if gate else None,
                    gate, pack=2)

            merged = None
            for lo, hi in packet_intersect.block_ranges(K, 2, pack=2):
                merged = packet_intersect._merge(merged, *run(lo, hi))
            for got in (run(0, K), merged):
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), gate
        one = fused1.fused1_closest_hit(od8, cull.box_table(hmin, hmax),
                                        half.cluster_blocks[:half.num_clusters].contiguous())
        assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])
        torch.cuda.synchronize()
        assert (fused1.LAUNCHES, fused1.LAUNCHES_PACK2) == (before[0] + 1, before[1] + 6)
        assert (ref[1] >= 0).any()


def test_packed_render_launches_pack2_and_matches_unpacked(cuda):
    packed, half = _packed_pair(cuda, rays_per_pixel=12, bounces=4,
                                max_rays_per_pixel_per_pass=10)
    modules = {"cull": cull, "fused": fused, "fused1": fused1, "sweep": sweep}
    counts = lambda: ({k: m.LAUNCHES for k, m in modules.items()}, fused1.LAUNCHES_PACK2)
    before = counts()
    fb = pipeline.render_framebuffer(packed)  # passes of 10 and 2: fused1 in both
    after = counts()
    assert after[0] == before[0] and after[1] > before[1]
    torch.cuda.synchronize()
    assert torch.equal(fb, pipeline.render_framebuffer(half)) and torch.isfinite(fb).all()


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_bounce_kernel_matches_plain_and_runs_forward_only(cuda, name):
    """The bounce kernel against its plain version (the torch shading) on
    the wavefront entering bounces 0-3, under the shade gate; a forward
    render launches it, a graph-building pass does not."""
    from cuda_raytracer_tpu_torch.ops.kernels import bounce

    scene = _scene(cuda, name)
    for b, state in enumerate(_states(scene, bounces=4)):
        _, t, hit_index, _ = wavefront.closest_hit_of(scene, state, b)
        before = bounce.LAUNCHES
        rows = wavefront.pack_rows(state)
        bounce.shade_rows(scene, rows, t, hit_index, 3, b)
        got = wavefront.unpack_rows(rows)
        assert bounce.LAUNCHES == before + 1
        ref = bounce.plain_shade_bounce(scene, state, t, hit_index, 3, b)
        a, r = torch.cat(list(got[:4]), dim=1), torch.cat(list(ref[:4]), dim=1)
        assert torch.isfinite(a).all() and torch.isfinite(r).all()
        assert float(((a - r).abs().amax(dim=1) < 1e-3).float().mean()) >= 0.999
        assert torch.equal(got.ray_id, state.ray_id)
    before = bounce.LAUNCHES
    pipeline.render_framebuffer(scene.with_config(rays_per_pixel=2))
    assert bounce.LAUNCHES > before
    before = bounce.LAUNCHES
    params = diff.make_leaves(diff.split_params(scene)[0])
    diff.render_radiance(params, scene, 0, 2, 3).sum().backward()
    assert bounce.LAUNCHES == before


def test_fused1_split_bit_equal_plain(cuda):
    """fused1 with each tile's boxes split over 2, 3 and more blocks than it
    has chunks, flat and gated, pack 1 and 2: bit-equal to its plain
    version."""
    for pack in (1, 2):
        scene = _scene(cuda, cluster_pack=pack) if pack == 1 else scene_dsl.assemble_scene(
            builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL),
            config_overrides=dict(width=32, height=32, cluster_pack=2), cluster_tris=64,
            device=cuda)
        K = scene.num_clusters
        aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
        blocks = scene.cluster_blocks[:K // pack].contiguous()
        for state in _states(scene):
            alive = torch.any(state.transmitted != 0, dim=-1)
            rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                              torch.where(alive, 1e30, -1.0)[:-7], 64)
            od8 = cull.make_od8(*rays, 64)
            ref = fused1.plain_fused1(od8, aabb, blocks, pack=pack)
            for gate in (0, 4):
                sup = (fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate)
                       if gate else None)
                for splits in (1, 2, 3, -(-K // fused1.SPLIT_CHUNK) + 2, None):
                    got = fused1.fused1_closest_hit(od8, aabb, blocks, sup, gate, pack=pack,
                                                    splits=splits)
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                        pack, gate, splits)


def _host_fused1_lib(tmp_path):
    """``csrc/packet_host.cpp`` built with the host C++ compiler: the same
    fused1 body on the CPU, which ``test_torch_packet_host.py`` holds to a
    PyTorch recount of the counters."""
    import ctypes
    import shutil
    import subprocess

    from cuda_raytracer_tpu_torch.ops.kernels import build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    path = tmp_path / "libpacket_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(path), str(build.CSRC_DIR / "packet_host.cpp")], check=True)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_host_fused1_closest_hit.argtypes = [p] * 3 + [i] * 2 + [p] + [i] * 7 + [p] * 3
    return lib


@pytest.mark.parametrize("pack", [1, 2])
def test_fused1_rows_splits_counters(cuda, tmp_path, pack):
    """The fused1 kernel's block body (groups of ray lanes sharing each swept
    cluster, the cull spread over the block, double-buffered staging) on a
    torus of 171 clusters of 256 triangles (pack 1: 8 groups of lanes) or
    342 sub-clusters of 128 two to a block (pack 2: 4 groups), entering
    bounces 0 and 1 of 32×32 × 256 spp: at 1, 65, 4,097 and 2^18 - 7 rays
    from the middle of the wavefront (a ragged last tile), flat and gated, at one block per tile, at
    ``split_plan``'s choice for that many tiles and at more splits than
    chunks, bit-equal to ``plain_fused1``, one launch a call; the counters
    at one split equal the host build's on the same rays (the host build's
    are held to a PyTorch recount on the CPU)."""
    parsed = builtin_scenes.parse_mesh_scene("torus", (144, 96))
    scene = scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=32, height=32, cluster_pack=pack),
        cluster_tris=256, device=cuda)
    K = scene.num_clusters
    assert K > fused1.CHUNK
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    blocks = scene.cluster_blocks[:K // pack].contiguous()
    host = _host_fused1_lib(tmp_path)
    launches = lambda: fused1.LAUNCHES if pack == 1 else fused1.LAUNCHES_PACK2
    n_chunks = -(-K // fused1.SPLIT_CHUNK)
    for state in _states(scene, rpp=256):
        alive = torch.any(state.transmitted != 0, dim=-1)
        window = torch.where(alive, 1e30, -1.0)
        R = window.shape[0]
        for n in (1, 65, 4097, (1 << 18) - 7):
            lo = (R - n) // 2  # rays from the middle of the image
            od8 = cull.make_od8(*packet_intersect._pad_rays(
                state.origin[lo:lo + n], state.direction[lo:lo + n], window[lo:lo + n], 64), 64)
            T = od8.shape[0]
            ref = fused1.plain_fused1(od8, aabb, blocks, pack=pack)
            for gate in (0, 16):
                sup = (fused1.shard_supers(scene.cluster_min, scene.cluster_max, gate)
                       if gate else None)
                for splits in sorted({1, fused1.split_plan(T, K, gate)[0], n_chunks + 2}):
                    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
                    before = launches()
                    got = fused1.fused1_closest_hit(od8, aabb, blocks, sup, gate, stats=stats,
                                                    pack=pack, splits=splits)
                    assert launches() == before + 1
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                        n, gate, splits)
                    if splits > 1 or n > 4097:
                        continue
                    host_stats = torch.zeros(3, dtype=torch.int64)
                    t, tri = torch.empty_like(ref[0].cpu()), torch.empty_like(ref[1].cpu())
                    od8_c, aabb_c, blocks_c = od8.cpu(), aabb.cpu(), blocks.cpu()
                    sup_c = sup.cpu() if gate else None
                    host.rt_host_fused1_closest_hit(
                        od8_c.data_ptr(), aabb_c.data_ptr(),
                        sup_c.data_ptr() if gate else None, sup.shape[0] if gate else 0,
                        gate, blocks_c.data_ptr(), T, K, blocks.shape[2], pack, 64, 1,
                        fused1.CHUNK, t.data_ptr(), tri.data_ptr(), host_stats.data_ptr())
                    assert torch.equal(t, got[0].cpu()) and torch.equal(tri, got[1].cpu())
                    assert stats.cpu().tolist() == host_stats.tolist(), (n, gate)
            assert n == 1 or (ref[1] >= 0).any()


def test_fused_split_bit_equal_plain(cuda):
    """fused with each tile's selected clusters split over 1, 2, 3 and more
    blocks than a tile selects, and at split_plan's choice, with and
    without the skip test: bit-equal to its plain version."""
    scene = _scene(cuda)
    K = scene.num_clusters
    aabb = cull.box_table(scene.cluster_min, scene.cluster_max)
    blocks = scene.cluster_blocks[:K].contiguous()
    for state in _states(scene, bounces=3):
        alive = torch.any(state.transmitted != 0, dim=-1)
        rays = packet_intersect._pad_rays(state.origin[:-7], state.direction[:-7],
                                          torch.where(alive, 1e30, -1.0)[:-7], 64)
        od8 = cull.make_od8(*rays, 64)
        entry, mask = cull.cull_tiles(od8, aabb, with_mask=True)
        select = entry < cull.MISS_ENTRY * 0.5
        words = fused.pack_words(select)
        ref = fused.plain_fused(od8, blocks, words)
        many = int(select.sum(dim=1).max()) + 3
        for skip in (False, True):
            for splits in (1, 2, 3, many, None):
                got = fused.fused_closest_hit(od8, blocks, words, entry if skip else None,
                                              mask if skip else None, splits=splits)
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                    skip, splits)


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_bvh_walk_bit_equal_plain(cuda, name):
    scene = _scene(cuda, name, intersector="bvh")
    for state in _states(scene, bounces=3):
        rows = wavefront.pack_rows(state)[:-5]  # a ragged last block of threads
        alive = rays.rows_alive(rows)
        t0, i0 = intersect.intersect_spheres(
            rows[:, 0:3], rows[:, 3:6], scene.sphere_center, scene.sphere_radius)
        t0 = torch.where(alive, t0, -1.0)  # dead rays: no work
        before = traverse_kernel.LAUNCHES
        got = traverse_kernel.bvh_walk(scene, rows[:, 0:3], rows[:, 3:6], t0, i0)
        assert traverse_kernel.LAUNCHES == before + 1
        want = traverse.plain_bvh_closest_hit(scene, rows[:, 0:3], rows[:, 3:6], t0, i0)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert (got[0][~alive] == -1).all()


@pytest.mark.parametrize("n", [1, 31, 33, 657])
def test_bvh_walk_launches_bit_equal_plain(cuda, n):
    """n rays of a bounced wavefront with the rays a warp the kernel picks
    and at 1, 5 and 32: each one launch, bit-equal to the plain walk."""
    scene = _scene(cuda, intersector="bvh")
    state = list(_states(scene, bounces=2))[1]
    rows = wavefront.pack_rows(state)[:n]
    alive = rays.rows_alive(rows)
    t0, i0 = intersect.intersect_spheres(
        rows[:, 0:3], rows[:, 3:6], scene.sphere_center, scene.sphere_radius)
    t0 = torch.where(alive, t0, -1.0)
    o, d = rows[:, 0:3], rows[:, 3:6]
    want = traverse.plain_bvh_closest_hit(scene, o, d, t0, i0)
    for lanes in (0, 1, 5, 32):
        before = traverse_kernel.LAUNCHES
        got = traverse_kernel.bvh_walk(scene, o, d, t0, i0, lanes=lanes)
        assert traverse_kernel.LAUNCHES == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), lanes
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), lanes
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    traverse_kernel.bvh_walk(scene, o, d, t0, i0, stats=stats)
    assert int(stats[3]) >= 1 and int(stats[0]) >= n
    with pytest.raises(ValueError, match="lanes"):
        traverse_kernel.bvh_walk(scene, o, d, t0, i0, lanes=33)


def test_bvh_render_launches_the_walk_and_refuses_bad_inputs(cuda):
    scene = _scene(cuda, intersector="bvh", rays_per_pixel=2, bounces=3)
    before = (traverse_kernel.LAUNCHES, cull.LAUNCHES, fused.LAUNCHES)
    fb = pipeline.render_framebuffer(scene)
    assert torch.isfinite(fb).all()
    assert traverse_kernel.LAUNCHES > before[0]
    assert (cull.LAUNCHES, fused.LAUNCHES) == before[1:]
    o = torch.zeros((8, 3), device=cuda)
    t = torch.full((8,), 1e30, device=cuda)
    i = torch.full((8,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        traverse_kernel.bvh_walk(scene, o, o, t, i.long())
    with pytest.raises(ValueError, match="unit column stride"):
        traverse_kernel.bvh_walk(scene, o, o.t().contiguous().t(), t, i)
    # A chain of 31 inner nodes, each with a leaf child: one level deeper
    # than the walk's stack holds.
    depth = traverse.MAX_BVH_DEPTH + 1
    child1 = [v for k in range(depth) for v in (2 * k + 1, 0)] + [1]
    child2 = [v for k in range(depth) for v in (2 * k + 2, 0)] + [0]
    box = torch.full((len(child1), 3), -10.0, device=cuda)
    deep = scene.replace(bvh_min=box, bvh_max=-box,
                         bvh_child1=torch.tensor(child1, dtype=torch.int32, device=cuda),
                         bvh_child2=torch.tensor(child2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="MAX_BVH_DEPTH"):
        traverse_kernel.bvh_walk(deep, o, o, t, i)


def test_auto_renders_meshes_through_the_walk(cuda):
    """"auto" on the card: the torus's passes of 10 and 2 rays a pixel walk
    the BVH, no packet kernel launches, the framebuffer is the one of
    ``intersector="bvh"`` bit for bit, and every row handed to a closest
    hit went to the walk."""
    from cuda_raytracer_tpu_torch.utils import metrics

    scene = _scene(cuda, intersector="auto", rays_per_pixel=12, bounces=4,
                   max_rays_per_pixel_per_pass=10)
    assert wavefront.resolved_intersector(scene) == "bvh"
    packet = lambda: (cull.LAUNCHES, cull.LAUNCHES_GATED, fused.LAUNCHES, fused1.LAUNCHES,
                      fused1.LAUNCHES_PACK2, sweep.LAUNCHES)
    before = (traverse_kernel.LAUNCHES, packet())
    m = metrics.Metrics()
    fb = pipeline.render_framebuffer(scene, metrics=m)
    assert traverse_kernel.LAUNCHES > before[0] and packet() == before[1]
    assert torch.equal(fb, pipeline.render_framebuffer(scene.with_config(intersector="bvh")))
    counters = m.resolve().counters
    assert counters["hit.walk_rows"] == counters["hit.rows"] >= 12 * 32 * 32


def test_cullhit_keys_bit_equal_plain(cuda):
    scene = _scene(cuda, sort_key="cullhit")
    K, S = scene.num_clusters, scene.config.cull_split
    for state in _states(scene, bounces=3):
        rows = wavefront.pack_rows(state)[:-3]
        for count in (False, True):
            for chunk in (rows.shape[0], 1000):
                before = rays.LAUNCHES_CULLHIT
                got = rays.cullhit_keys(rows, scene.cluster_min, scene.cluster_max, K, S,
                                        count, chunk)
                assert rays.LAUNCHES_CULLHIT == before + 1
                want = rays.plain_cullhit_keys(rows, scene.cluster_min, scene.cluster_max,
                                               K, S, count, chunk)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="box_min"):
        rays.cullhit_keys(rows, scene.cluster_min[:2], scene.cluster_max, K, S, False, 64)


def test_cullhit_render_launches_its_keys_and_matches_morton(cuda):
    scene = _scene(cuda, rays_per_pixel=4, bounces=4)
    ref = pipeline.render_framebuffer(scene)
    before = (rays.LAUNCHES_CULLHIT, rays.LAUNCHES_KEYS)
    fb = pipeline.render_framebuffer(scene.with_config(sort_key="cullhit"))
    assert rays.LAUNCHES_CULLHIT > before[0] and rays.LAUNCHES_KEYS == before[1]
    assert torch.equal(fb, ref)


def _key_pair(scene, rows, count, chunk):
    """(Morton kernel, plain, cullhit kernel, plain) outputs on ``rows``."""
    K, S = scene.num_clusters, scene.config.cull_split
    boxes = (scene.cluster_min, scene.cluster_max, K, S)
    return (rays.ray_keys(rows, scene.min_coord, scene.inv_extent, count, chunk),
            rays.plain_ray_keys(rows, scene.min_coord, scene.inv_extent, count, chunk),
            rays.cullhit_keys(rows, *boxes, count, chunk),
            rays.plain_cullhit_keys(rows, *boxes, count, chunk))


@pytest.mark.parametrize("split", [1, 2])
def test_key_kernels_bit_equal_plain_at_edge_counts(cuda, split):
    scene = _scene(cuda, sort_key="cullhit", cull_split=split)
    rows = wavefront.pack_rows(_states(scene, bounces=2)[1])
    full = rows.repeat(pipeline.RAY_BLOCK // rows.shape[0], 1)
    for n in (1, 255, 256, 257, rows.shape[0], full.shape[0]):
        part = full[:n]
        for count in (False, True):
            got, want, got_c, want_c = _key_pair(scene, part, count, min(n, 1000))
            for g, w in ((got, want), (got_c, want_c)):
                assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]), (n, count)
    assert 0 < int(want_c[1]) < full.shape[0]


def test_key_kernels_live_counts_back_to_back(cuda):
    """Three launches of each key kernel queued without a sync or a reset,
    interleaved on one stream, then again on a second stream: every live
    count right (each launch leaves its stream's scratch zero)."""
    scene = _scene(cuda, sort_key="cullhit")
    K, S = scene.num_clusters, scene.config.cull_split
    states = _states(scene, bounces=3)
    rows = [wavefront.pack_rows(s) for s in states]
    rows = [rows[0], rows[1][:1000], rows[2][:3001]]
    want = [int(rays.rows_alive(r).sum()) for r in rows]
    for stream in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            lives = []
            for r in rows:
                lives.append(rays.ray_keys(r, scene.min_coord, scene.inv_extent, False,
                                           r.shape[0])[1])
                lives.append(rays.cullhit_keys(r, scene.cluster_min, scene.cluster_max, K, S,
                                               True, 512)[1])
        stream.synchronize()
        assert [int(x) for x in lives] == [w for w in want for _ in range(2)]
    assert len({w for w in want}) == 3


def test_cullhit_keys_staged_in_steps_bit_equal_plain(cuda):
    """6,000 boxes (K = 3,000 squeezed to 11 bits, ``cull_split`` 2): more
    than the kernel stages at once, so the table is staged in two steps."""
    r = np.random.default_rng(3)
    K, S, R = 3000, 2, 4099
    centers = r.uniform(-3, 3, (K * S, 3)).astype(np.float32)
    half = r.uniform(0.05, 0.5, (K * S, 3)).astype(np.float32)
    centers[4500:, 0] += 100.0  # high first ids for the rays moved along x
    o = r.uniform(-2, 2, (R, 3)).astype(np.float32)
    o[:R // 2, 0] += 100.0
    d = r.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rows = torch.zeros((R, 16))
    rows[:, 0:3], rows[:, 3:6] = torch.from_numpy(o), torch.from_numpy(d)
    rows[:, 6:9] = torch.from_numpy((r.uniform(size=R) < 0.9).astype(np.float32))[:, None]
    rows = rows.to(cuda)
    bmin = torch.from_numpy(centers - half).to(cuda)
    bmax = torch.from_numpy(centers + half).to(cuda)
    for count in (False, True):
        got = rays.cullhit_keys(rows, bmin, bmax, K, S, count, 2048)
        want = rays.plain_cullhit_keys(rows, bmin, bmax, K, S, count, 2048)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    keys, _ = rays.plain_cullhit_keys(rows, bmin, bmax, K, S, False, R)
    fh = keys[rays.rows_alive(rows)] >> 21 & 0x7FF
    assert (fh >= 2047 * 2250 // K).sum() > 100


@pytest.mark.parametrize("ray_lo,n,rpp,seed", [
    (0, 32 * 32 * 20, 20, 80), (1237, 5000, 4, 2**31 + 5), (7, 1, 1, 0),
    (2**31 - 300, 300, 8, 19)])
def test_camera_rows_bit_equal_plain(cuda, ray_lo, n, rpp, seed):
    scene = _scene(cuda)
    words = rays.camera_words(scene.camera)
    before = rays.LAUNCHES_CAMERA
    got = rays.camera_rows(words, ray_lo, n, rpp, scene.config.width, seed)
    assert rays.LAUNCHES_CAMERA == before + 1
    want = rays.plain_camera_rows(words, ray_lo, n, rpp, scene.config.width, seed)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_forward_render_launches_camera_rows_once_a_block(cuda, monkeypatch):
    """Passes of 10 and 2 rays a pixel over 32×32 pixels in blocks of at
    most 4,096 rays: 3 + 1 blocks."""
    scene = _scene(cuda, rays_per_pixel=12, bounces=4, max_rays_per_pixel_per_pass=10)
    monkeypatch.setattr(pipeline, "RAY_BLOCK", 4096)
    before = (rays.LAUNCHES_CAMERA, rays.LAUNCHES_DRAWS)
    fb = pipeline.render_framebuffer(scene)
    assert (rays.LAUNCHES_CAMERA, rays.LAUNCHES_DRAWS) == (before[0] + 4, before[1])

    def old_trace_camera(scene, ray_lo, n, rpp, pass_seed, *args, **kwargs):
        ids = ray_lo + torch.arange(n, dtype=torch.int32, device=scene.device)
        state = wavefront.make_initial_state(scene, ids, rpp, pass_seed)
        return packed.trace_wavefront(scene, state, pass_seed, *args, **kwargs)

    monkeypatch.setattr(packed, "trace_camera", old_trace_camera)
    assert torch.equal(pipeline.render_framebuffer(scene), fb)
    assert rays.LAUNCHES_CAMERA == before[0] + 4 and rays.LAUNCHES_DRAWS > before[1]


def test_differentiable_render_draws_through_pcg_draws(cuda):
    scene = _scene(cuda)
    before = (rays.LAUNCHES_CAMERA, rays.LAUNCHES_DRAWS)
    params = diff.make_leaves(diff.split_params(scene)[0])
    diff.render_radiance(params, scene, 0, 2, 3).square().mean().backward()
    torch.cuda.synchronize()
    assert rays.LAUNCHES_CAMERA == before[0] and rays.LAUNCHES_DRAWS > before[1]


@pytest.mark.parametrize("n,tile", [(1, 64), (31, 0), (33, 32), (257, 64), (4096, 64),
                                    (4096, 0)])
def test_rays_setup_live_counter_keeps_the_bits(cuda, n, tile):
    """The set-up kernel given a live counter: outputs bit-equal to the
    launch without one, the counter up by the live rows at every launch
    (bounced rows in shuffled order, live and dead mixed, ragged warps)."""
    scene = _scene(cuda)
    rows = wavefront.pack_rows(_states(scene, bounces=3)[2])
    g = torch.Generator().manual_seed(n)
    rows = rows[torch.randperm(rows.shape[0], generator=g).to(cuda)[:n]].contiguous()
    want = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, tile)
    live = torch.zeros(1, dtype=torch.int64, device=cuda)
    for k in (1, 2):
        got = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, tile, live)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
        assert (got[3] is None) == (tile == 0) and (tile == 0 or torch.equal(got[3], want[3]))
        assert int(live) == k * int(want[0].sum())
    if n >= 257:
        assert want[0].any() and (~want[0]).any()


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_bounce_kernel_dielectric_counter_keeps_the_bits(cuda, name):
    """The bounce kernel given a ``shade.dielectric`` counter: rows bit-equal
    to the launch without one, the counter up by the rows scattered off a
    dielectric at every launch, as the plain version counts them (none on
    the diffuse torus), on bounces 0-2 of the walk's wavefront."""
    from cuda_raytracer_tpu_torch.ops.kernels import bounce

    scene = _scene(cuda, name, intersector="bvh")
    total = 0
    for b, state in enumerate(_states(scene, bounces=3)):
        alive, t, hit_index, _ = wavefront.closest_hit_of(scene, state, b)
        rows = wavefront.pack_rows(state)
        want = rows.clone()
        bounce.shade_rows(scene, want, t, hit_index, 3, b)
        plain = torch.zeros(1, dtype=torch.int64, device=cuda)
        bounce.plain_shade_rows(scene, rows.clone(), t, hit_index, 3, b, dielectric=plain)
        counter = torch.zeros(1, dtype=torch.int64, device=cuda)
        for k in (1, 2):
            got = rows.clone()
            bounce.shade_rows(scene, got, t, hit_index, 3, b, dielectric=counter)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert int(counter) == k * int(plain)
        total += int(plain)
    assert (total > 0) == (name == "glass_torus")


def test_rays_setup_tail_counter_gets_the_live_rows(cuda):
    scene = _scene(cuda)
    rows = wavefront.pack_rows(_states(scene, bounces=3)[2])
    want = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, 0)
    live, tail = (torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2))
    got = rays.rays_setup(rows, scene.sphere_center, scene.sphere_radius, 0, live, tail)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert int(tail) == int(live) == int(want[0].sum()) > 0


def test_recorded_glass_render_counts_the_dielectric_and_the_tail(cuda):
    """A glass render through "auto" (the walk) into an attached registry:
    the framebuffer of the render without one, rows scattered off the glass,
    and a tail (bounces 5-9 of 10) with fewer live rays than the whole and
    less time than every bounce's."""
    from cuda_raytracer_tpu_torch.utils import metrics

    scene = _scene(cuda, "glass_torus", intersector="auto", rays_per_pixel=4, bounces=10)
    fb = pipeline.render_framebuffer(scene)
    m = metrics.Metrics()
    assert torch.equal(pipeline.render_framebuffer(scene, metrics=m), fb)
    counters = m.resolve().counters
    assert counters["hit.walk_rows"] == counters["hit.rows"] > 0
    assert 0 < counters["shade.dielectric"] < counters["rays.live"]
    assert 0 < counters["rays.live_tail"] < counters["rays.live"]
    assert 0 < m.phases["rt.tail"] < m.phases["rt.bounce"]


def test_recorded_render_keeps_its_bits_and_counts(cuda, monkeypatch):
    """A render into an attached registry over 32×32 × 4 in blocks of 2,048
    rays (2 blocks of 4 bounces, 3 sorted): the framebuffer of the render
    without one, a live-count read per sorted bounce with the device idle
    it caused, and the live rows the set-up kernel summed."""
    from cuda_raytracer_tpu_torch.utils import metrics

    scene = _scene(cuda, rays_per_pixel=4, bounces=4)
    monkeypatch.setattr(pipeline, "RAY_BLOCK", 2048)
    fb = pipeline.render_framebuffer(scene)
    m = metrics.Metrics()
    assert torch.equal(pipeline.render_framebuffer(scene, metrics=m), fb)
    counters = m.resolve().counters
    assert counters["sync.host"] == 2 * 3
    assert counters["rays.launched"] >= counters["rays.live"] > 2 * 2048
    assert counters["sync.device_idle_s"] > 0
    assert m.phases["rt.bounce"] > 0
    # each read's event pair was read and went back to the pool
    assert not m._idle and sum(map(len, m._events.values())) == 2 * 2 * 3
