"""The pair sweep (kernel B6's plain version) and the "pallas" packet engine against the JAX package.

``ops/kernels/sweep.plain_sweep`` is held against the Pallas
``_sweep_kernel`` in interpret mode (``sweep_pairs(..., interpret=True)``)
on the same rays, blocks and pair list (also the lists the kernel's
range-split cases use), and the port's ``"pallas"`` engine
against JAX's ``"pallas_interpret"`` engine, one-round, two-round and with a
pair budget that overflows. Triangle ids and overflow counts are EXACT; hit
distances are held to rtol 1e-4, because XLA's CPU backend contracts
multiply-adds into FMAs and so its floats cannot be reproduced by code that
rounds each operation (see test_torch_packet.py). Within the port the sweep
is order-independent bit for bit, and the pallas engine equals the xla
engine whenever its budget holds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops import packet_intersect as jpi
from cuda_raytracer_tpu.ops.pallas import sweep as jsweep

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.ops.kernels import cull, sweep

from test_torch_packet import _cloud_text, _rays, build_mesh_both


@pytest.fixture(scope="module")
def cloud():
    """3000 random triangles in clusters of 64: K > ROUND1_NEAREST."""
    return build_mesh_both(_cloud_text(3000), cluster_tris=64)


@pytest.fixture(scope="module")
def torus():
    """The small torus in clusters of 32 (K > ROUND1_NEAREST)."""
    return build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL), cluster_tris=32,
                           sky=True)


def _pair_inputs(ts, n, tile, seed):
    """Rays, their rays_tiles and the culled pair list of the first tiles
    (tile-major, then (T, 0) sentinels to a budget past the count)."""
    o, d, t0, _ = _rays(n, seed=seed)
    op, dp, wp = packet_intersect._pad_rays(*(torch.from_numpy(a) for a in (o, d, t0)), tile)
    od8 = cull.make_od8(op, dp, wp, tile)
    entry = cull.plain_cull(od8, cull.box_table(ts.cluster_min, ts.cluster_max))
    select = entry < packet_intersect.HIT_THRESH
    T = od8.shape[0]
    pairs, total, overflow = packet_intersect.extract_pairs(select, int(select.sum()) + 13)
    assert int(overflow) == 0 and int(total) == int(select.sum()) > 10
    return sweep.make_rays_tiles(op, dp, tile), pairs, total, T


def _jax_sweep(rays_tiles, blocks, pairs, total, tile):
    t, tri = jsweep.sweep_pairs(jnp.asarray(rays_tiles.numpy()), jnp.asarray(blocks.numpy()),
                                jnp.asarray(pairs.numpy()), jnp.asarray(total.numpy()),
                                tile=tile, interpret=True)
    return np.asarray(t), np.asarray(tri)


@pytest.mark.parametrize("scene_name,n,tile", [("cloud", 200, 64), ("torus", 150, 32)])
def test_plain_sweep_matches_jax_interpret(cloud, torus, scene_name, n, tile):
    """Rows [:T] equal JAX's kernel (ids exact, t within rtol 1e-4), in the
    tile-major order and shuffled; row T (the dummy tile) is a miss."""
    _, ts = {"cloud": cloud, "torus": torus}[scene_name]
    rays_tiles, pairs, total, T = _pair_inputs(ts, n, tile, seed=n)
    assert rays_tiles.shape == (T + 1, 8, 128)
    blocks = ts.cluster_blocks
    t_ref, tri_ref = _jax_sweep(rays_tiles, blocks, pairs, total, tile)
    launches = sweep.LAUNCHES
    t, tri = sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile)
    assert sweep.LAUNCHES == launches  # the plain version on the CPU
    assert t.shape == (T + 1, tile) and tri.dtype == torch.int32
    np.testing.assert_array_equal(tri[:T].numpy(), tri_ref[:T])
    np.testing.assert_allclose(t[:T].numpy(), t_ref[:T], rtol=1e-4, atol=0)
    assert (tri[:T] >= 0).sum() > n // 4  # the case has hits to compare
    assert bool((t[T] == sweep.MISS).all()) and bool((tri[T] == -1).all())
    # Any order of the same pairs gives the same bits (and JAX's kernel
    # agrees on the shuffled list too).
    k = int(total)
    perm = torch.from_numpy(np.random.default_rng(n).permutation(k))
    shuffled = pairs.clone()
    shuffled[:, :k] = pairs[:, perm]
    got = sweep.sweep_pairs(rays_tiles, blocks, shuffled, total, tile)
    assert torch.equal(got[0], t) and torch.equal(got[1], tri)
    np.testing.assert_array_equal(_jax_sweep(rays_tiles, blocks, shuffled, total, tile)[1][:T],
                                  tri_ref[:T])


def test_sweep_sentinels_budget_and_checks(cloud):
    """Pairs past ``total`` are never swept, a total past P is cut to P, and
    out-of-range ids are skipped; bad inputs raise."""
    _, ts = cloud
    rays_tiles, pairs, total, T = _pair_inputs(ts, 200, 64, seed=3)
    blocks = ts.cluster_blocks
    k = int(total)
    half = torch.tensor(k // 2, dtype=torch.int32)
    ref = sweep.plain_sweep(rays_tiles, blocks, pairs[:, :k // 2].contiguous(),
                            torch.tensor(k // 2, dtype=torch.int32), 64)
    got = sweep.sweep_pairs(rays_tiles, blocks, pairs, half, 64)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    big = torch.tensor(pairs.shape[1] + 100, dtype=torch.int32)
    whole = sweep.sweep_pairs(rays_tiles, blocks, pairs, total, 64)
    bad = pairs.clone()
    bad[0, k:] = T + 5  # out of range past total: skipped even when total covers them
    got = sweep.sweep_pairs(rays_tiles, blocks, bad, big, 64)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    with pytest.raises(ValueError, match="pairs"):
        sweep.sweep_pairs(rays_tiles, blocks, pairs.long(), total, 64)
    with pytest.raises(ValueError, match="tile"):
        sweep.sweep_pairs(rays_tiles, blocks, pairs, total, 256)
    with pytest.raises(ValueError, match="total"):
        sweep.sweep_pairs(rays_tiles, blocks, pairs, total.long(), 64)


@pytest.mark.parametrize("scene_name,n,tile", [("cloud", 200, 64), ("torus", 150, 32)])
def test_range_split_lists_match_jax_interpret(cloud, torus, scene_name, n, tile):
    """The pair lists the range-split cases of the kernel's host build use
    (test_torch_packet_host.py): tile-major, shuffled, and a total that stops
    short of the selected pairs, each swept by the port (the plain version
    on the CPU, whatever ``ranges`` asks) and by JAX's kernel in interpret
    mode: ids exact, t within rtol 1e-4 (XLA's CPU FMA contraction); a
    range count below 1 is refused. The short list carries (T, 0) sentinels
    past its total, as ``extract_pairs`` writes them: JAX's kernel may sweep
    a sentinel (the dummy tile), the port never sweeps past the total."""
    _, ts = {"cloud": cloud, "torus": torus}[scene_name]
    rays_tiles, pairs, total, T = _pair_inputs(ts, n, tile, seed=n + 1)
    blocks = ts.cluster_blocks
    k = int(total)
    shuffled = pairs.clone()
    shuffled[:, :k] = pairs[:, torch.from_numpy(np.random.default_rng(n + 1).permutation(k))]
    short = torch.tensor(k * 2 // 3, dtype=torch.int32)
    cut = pairs.clone()
    cut[0, int(short):], cut[1, int(short):] = T, 0
    for pair_list, tot in ((pairs, total), (shuffled, total), (cut, short)):
        t_ref, tri_ref = _jax_sweep(rays_tiles, blocks, pair_list, tot, tile)
        for ranges in (None, 1, 3, 7, int(tot)):
            t, tri = sweep.sweep_pairs(rays_tiles, blocks, pair_list, tot, tile, ranges=ranges)
            np.testing.assert_array_equal(tri[:T].numpy(), tri_ref[:T])
            np.testing.assert_allclose(t[:T].numpy(), t_ref[:T], rtol=1e-4, atol=0)
        assert (tri[:T] >= 0).sum() > n // 8
    with pytest.raises(ValueError, match="ranges"):
        sweep.sweep_pairs(rays_tiles, blocks, pairs, total, tile, ranges=0)


def test_extract_pairs_layout():
    """Row-major (tile-major) pairs, (T, 0) sentinels, the overflow count."""
    select = torch.zeros((3, 5), dtype=torch.bool)
    select[0, 1] = select[0, 4] = select[2, 0] = select[2, 3] = True
    pairs, total, overflow = packet_intersect.extract_pairs(select, 6)
    assert pairs.tolist() == [[0, 0, 2, 2, 3, 3], [1, 4, 0, 3, 0, 0]]
    assert (int(total), int(overflow), total.dtype) == (4, 0, torch.int32)
    pairs, total, overflow = packet_intersect.extract_pairs(select, 3)
    assert pairs.tolist() == [[0, 0, 2], [1, 4, 0]]
    assert (int(total), int(overflow)) == (3, 1)


@pytest.mark.parametrize("scene_name,two_round,cap", [
    ("cloud", False, None), ("cloud", True, None), ("cloud", True, 1),
    ("torus", True, None), ("torus", False, 2),
])
def test_pallas_engine_matches_jax(cloud, torus, scene_name, two_round, cap):
    """The port's "pallas" engine against JAX's "pallas_interpret": hit
    indices and the certificate exact, t within rtol 1e-4; budgets that
    hold (cap = K) and that overflow (cap 1 and 2: every ray suspect)."""
    js, ts = {"cloud": cloud, "torus": torus}[scene_name]
    assert ts.num_clusters > packet_intersect.ROUND1_NEAREST
    o, d, t0, i0 = _rays(300, seed=11)
    cap = ts.num_clusters if cap is None else cap
    ref = jpi.closest_hit_packet(js, *(jnp.asarray(a) for a in (o, d, t0, i0)), tile=64,
                                 cap=cap, backend="pallas_interpret", two_round=two_round)
    got = packet_intersect.closest_hit_packet(
        ts, *(torch.from_numpy(a) for a in (o, d, t0, i0)), tile=64, cap=cap,
        backend="pallas", two_round=two_round)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4, atol=0)
    assert int(got[2]) == int(ref[2])
    if cap <= 2:
        assert int(got[2]) == 300  # all or nothing
    else:
        assert int(got[2]) == 0
        xla = packet_intersect.closest_hit_packet(
            ts, *(torch.from_numpy(a) for a in (o, d, t0, i0)), tile=64, cap=cap,
            backend="xla")
        assert torch.equal(got[0], xla[0]) and torch.equal(got[1], xla[1])
