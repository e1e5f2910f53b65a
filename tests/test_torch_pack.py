"""Paired sub-cluster tables (``cluster_pack=2``) in the port, against the JAX package.

A packed scene cuts the BVH at C/2 triangles and stores two sub-clusters
side by side in each (16, C) block; the cull runs over the sub-cluster
boxes and only the halves some ray of a tile hits are swept, so the
closest hits are those of an unpacked table cut at C/2. Tolerances:

- the packed scene's arrays EQUAL JAX's ``assemble_scene(...,
  config_overrides=dict(cluster_pack=2))`` (the same NumPy code);
- the packed fused1 engine (its plain version on the CPU; flat, gated and
  cut into two block-aligned shards) against JAX's ``"xla"`` engine on the
  same geometry cut at C/2, and against JAX's ``"fused1_interpret"`` engine
  on the packed table: hit indices EXACT, hit distances within rtol 1e-4
  (XLA's CPU backend contracts multiply-adds, see test_torch_packet.py);
- a packed wavefront render on the CPU BIT-EQUAL to the unpacked one at
  C/2; the engines that index blocks by box (``"xla"``, ``"fused"``,
  ``"pallas"``) raise ``ValueError`` on a packed scene, as JAX's do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.ops import packet_intersect as jpi

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.ops.kernels import cull, fused1
from cuda_raytracer_tpu_torch.render import pipeline

from test_torch_packet import _assert_hits_match_jax, _cloud_text, _rays, build_mesh_both

C = 64  # block width of the packed tables: sub-clusters of 32 triangles
PACKED = dict(cluster_pack=2)
TEXTS = {"cloud": _cloud_text(), "torus": builtin_scenes.torus(builtin_scenes.SMALL)}


@pytest.fixture(scope="module")
def tables():
    """{name: ((JAX, port) packed at C, (JAX, port) unpacked at C / 2)}."""
    return {name: (build_mesh_both(text, PACKED, cluster_tris=C, sky=name == "torus"),
                   build_mesh_both(text, cluster_tris=C // 2, sky=name == "torus"))
            for name, text in TEXTS.items()}


@pytest.mark.parametrize("name", ["cloud", "torus"])
def test_packed_scene_arrays_equal_jax(tables, name):
    (js, ts), (_, half) = tables[name]
    assert ts.num_clusters == js.num_clusters and ts.num_clusters % 2 == 0
    assert ts.cluster_tris == js.cluster_tris == C
    for field in ("cluster_min", "cluster_max", "cluster_blocks", "cluster_slot_tri"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field)))
    # Two sub-clusters per block plus the dummy block; the sub-clusters are
    # the unpacked C / 2 cut's, padded to an even count.
    assert ts.cluster_blocks.shape == (ts.num_clusters // 2 + 1, 16, C)
    K = half.num_clusters
    assert ts.num_clusters - K in (0, 1)
    assert torch.equal(ts.cluster_min[:K], half.cluster_min)
    assert torch.equal(fused1.sub_blocks(ts.cluster_blocks[:ts.num_clusters // 2], 2)[:K],
                       half.cluster_blocks[:K])


def _packed_hits(ts, rays, tile, case):
    """The packed fused1 engine's hits, whole (flat or gated) or merged over
    two block-aligned shards of the table."""
    if case != "two_shards":
        scene = ts.with_config(cull_hier=-1 if case == "flat" else 16)
        return packet_intersect.closest_hit_packet(scene, *rays, tile=tile, backend="fused1")
    o, d, t0, i0 = rays
    od8 = cull.make_od8(*packet_intersect._pad_rays(o, d, t0, tile), tile)
    K = ts.num_clusters
    out = None
    for lo, hi in packet_intersect.block_ranges(K, 2, pack=2):
        assert lo % 2 == 0 and hi % 2 == 0 and hi > lo
        aabb = cull.box_table(ts.cluster_min[lo:hi], ts.cluster_max[lo:hi])
        out = packet_intersect._merge(out, *fused1.fused1_closest_hit(
            od8, aabb, ts.cluster_blocks[lo // 2:hi // 2].contiguous(), pack=2))
    return packet_intersect._finalize(ts, *out, None, t0, i0, o.shape[0], tile)


@pytest.mark.parametrize("case", ["flat", "gated", "two_shards"])
@pytest.mark.parametrize("name,tile", [("cloud", 64), ("torus", 32)])
def test_packed_hits_match_jax_xla_at_half(tables, name, tile, case):
    (_, ts), (jhalf, half) = tables[name]
    o, d, t0, i0 = _rays(333, seed=17)
    ref = jpi.closest_hit_packet(jhalf, *(jnp.asarray(a) for a in (o, d, t0, i0)), tile=tile,
                                 cap=jhalf.num_clusters, backend="xla")
    assert int(ref[2]) == 0  # uncapped: exact
    rays = [torch.from_numpy(a) for a in (o, d, t0, i0)]
    launches = (fused1.LAUNCHES, fused1.LAUNCHES_PACK2)
    got = _packed_hits(ts, rays, tile, case)
    _assert_hits_match_jax(ref, got)
    assert (got[1] >= 0).sum() > 50
    assert (fused1.LAUNCHES, fused1.LAUNCHES_PACK2) == launches  # plain on the CPU
    # The port's own unpacked engine at C / 2 gives the same bits.
    unpacked = packet_intersect.closest_hit_packet(half, *rays, tile=tile, backend="fused1")
    assert torch.equal(got[0], unpacked[0]) and torch.equal(got[1], unpacked[1])


def test_packed_fused1_matches_jax_interpret():
    """~200 sub-clusters (two cull chunks), 128 rays, flat cull: the packed
    engine against JAX's pack=2 Pallas kernel in interpret mode."""
    js, ts = build_mesh_both(_cloud_text(6000), dict(PACKED, cull_hier=-1), cluster_tris=C)
    assert ts.num_clusters > fused1.CHUNK
    o, d, t0, i0 = _rays(128, seed=23, dead=(40, 50), windows=30)
    ref = jpi.closest_hit_packet(js, *(jnp.asarray(a) for a in (o, d, t0, i0)), tile=64,
                                 backend="fused1_interpret")
    got = packet_intersect.closest_hit_packet(ts, *(torch.from_numpy(a) for a in (o, d, t0, i0)),
                                              tile=64, backend="fused1")
    _assert_hits_match_jax(ref, got)
    assert (got[1] >= 0).sum() > 20


def test_packed_render_bit_equal_unpacked(tables):
    """A whole wavefront render (sorted, live-prefix compacted) of the packed
    torus through "auto" equals the unpacked C / 2 render bit for bit; with
    no 16 MB table limit in the way, the regime rule does not touch it."""
    (_, ts), (_, half) = tables["torus"]
    cfg = dict(width=16, height=16, rays_per_pixel=3, bounces=4)
    packed_fb = pipeline.render_framebuffer(ts.with_config(**cfg))
    assert torch.equal(packed_fb, pipeline.render_framebuffer(half.with_config(**cfg)))
    assert packed_fb.abs().sum() > 0


def test_packed_backend_rules(tables):
    (_, ts), _ = tables["cloud"]
    rays = [torch.from_numpy(a) for a in _rays(256)]
    for name in ("xla", "fused", "pallas"):
        with pytest.raises(ValueError, match="cluster_pack"):
            packet_intersect.closest_hit_packet(ts, *rays, backend=name)
    # "auto" means fused1 on a packed table on every device.
    for device in ("cpu", "cuda"):
        assert packet_intersect.resolve_backend("auto", torch.device(device), 2) == "fused1"
    scene = ts.with_config(width=8, height=8, rays_per_pixel=12, bounces=2)
    assert scene.config.packet_backend == "auto"
    assert torch.isfinite(pipeline.render_framebuffer(scene)).all()
    with pytest.raises(ValueError, match="pack=3"):
        fused1.fused1_closest_hit(cull.make_od8(*rays[:3], 64),
                                  cull.box_table(ts.cluster_min, ts.cluster_max),
                                  ts.cluster_blocks, pack=3)
    with pytest.raises(ValueError, match="must divide K"):
        fused1.fused1_closest_hit(cull.make_od8(*rays[:3], 64),
                                  cull.box_table(ts.cluster_min[:-1], ts.cluster_max[:-1]),
                                  ts.cluster_blocks, pack=2)
