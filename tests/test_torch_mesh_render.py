"""The port's mesh-scene render path against the JAX package, on the CPU.

The small torus and glass torus (``builtin_scenes.MESH_SCENES`` at
``SMALL``, 770 triangles with the ground quad, above the 512-triangle packet
threshold) are assembled by both packages from the same text, with the same
substitute sky. With the default config (``intersector="auto"``,
``sort_rays=True``) both render through the packet intersector's xla engine,
the Morton reorder, live-prefix compaction and the by-ray-id unsort. The
framebuffers are held to the repo's per-pixel agreement gate
(tests/test_render_parity.py): max |Δ| < 1e-3 on at least 99.9 % of pixels,
all finite, and the port's render traces bounce by bounce (no CUDA graph
off the card). Within the port, reordering, ray blocking and the kernel
engines must not change a single bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cuda_raytracer_tpu.render import pipeline as jpipeline
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.ops import packet_intersect
from cuda_raytracer_tpu_torch.render import packed, pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

from test_torch_packet import build_mesh_both

SMALL = dict(width=16, height=16, rays_per_pixel=4, bounces=4)


def _both(name, **overrides):
    text = builtin_scenes.MESH_SCENES[name](builtin_scenes.SMALL)
    return build_mesh_both(text, dict(SMALL, **overrides), sky=True)


def assert_pixels_agree(got, ref):
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    diff = np.abs(got - ref).max(axis=1)
    agree = (diff < 1e-3).mean()
    assert agree >= 0.999, f"only {agree:.2%} of pixels agree (worst {diff.max():.3g})"


@pytest.mark.parametrize("name", ["torus", "glass_torus"])
def test_mesh_render_matches_jax(name):
    js, ts = _both(name)
    assert wavefront.resolved_intersector(ts) == "packet" and ts.config.sort_rays
    ref = np.asarray(jpipeline.render_framebuffer(js))
    recorded = metrics.Metrics()
    fb = pipeline.render_framebuffer(ts, metrics=recorded)
    # the CPU traces bounce by bounce: no CUDA graph is captured or replayed
    assert recorded.counters["bounces.packed"] == 4 and not (
        {"bounces.graphed", "graph.captures"} & set(recorded.counters))
    assert fb.shape == (256, 3)
    assert_pixels_agree(fb.numpy(), ref)
    img = pipeline.render_image(ts, framebuffer=fb)
    img_ref = jpipeline.render_image(js, framebuffer=jnp.asarray(ref))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert (np.abs(img.astype(int) - img_ref.astype(int)) <= 1).all(axis=2).mean() >= 0.99
    assert 20 <= img.mean() <= 235


def test_trace_live_bounds_match_jax():
    js, ts = _both("torus")
    rays = 16 * 16 * 4
    ids = np.arange(rays, dtype=np.int32)
    jstate = jwavefront.make_initial_state(js, jnp.asarray(ids), 4, 2)
    tstate = wavefront.make_initial_state(ts, torch.from_numpy(ids), 4, 2)
    ref = np.asarray(jwavefront.trace_live_bounds(js, jstate, 2, 6, True)).tolist()
    got = packed.trace_live_bounds(ts, tstate, 2, 6, True)
    assert got == ref and got[0] == rays and got[-1] < rays


def test_sort_blocks_and_chunks_do_not_change_bits(monkeypatch):
    """sort_rays on/off, a pass cut into several ray blocks, and chunk-local
    sorting (a wavefront larger than the sort chunk, so the live prefix is
    off and the unsort is per chunk) all give the same framebuffer, bit for
    bit; so do the fused and fused1 engines (plain versions on the CPU)."""
    _, ts = _both("glass_torus", width=32, height=32, rays_per_pixel=8)
    ref = pipeline.render_framebuffer(ts)
    assert torch.equal(pipeline.render_framebuffer(ts.with_config(sort_rays=False)), ref)
    for backend in ("fused", "fused1"):
        assert torch.equal(pipeline.render_framebuffer(ts.with_config(packet_backend=backend)),
                           ref)
    monkeypatch.setattr(wavefront, "SORT_CHUNK", 4096)
    assert wavefront.sort_chunk_size(32 * 32 * 8) == 4096
    assert torch.equal(pipeline.render_framebuffer(ts), ref)
    monkeypatch.setattr(pipeline, "RAY_BLOCK", 1000)  # 8 blocks of 125 pixels + 24
    assert torch.equal(pipeline.render_framebuffer(ts), ref)


def test_certificate_retries_then_raises():
    """The xla engine's certificate fires on a tiny packet cap: the render
    raises with auto_retry=False, and otherwise re-renders with a doubled
    cap to the same framebuffer as an adequate cap. A stale live_schedule
    is dropped first."""
    _, ts = _both("torus", rays_per_pixel=2, bounces=3)
    full = pipeline.render_framebuffer(ts.with_config(packet_cap=ts.num_clusters))
    tiny = ts.with_config(packet_cap=1)
    with pytest.raises(RuntimeError, match="exactness certificate"):
        pipeline.render_framebuffer(tiny, auto_retry=False)
    with pytest.warns(UserWarning, match="re-rendering with packet_cap"):
        assert torch.equal(pipeline.render_framebuffer(tiny), full)
    stale = ts.with_config(live_schedule=(64,))
    with pytest.warns(UserWarning, match="live_schedule"):
        assert torch.equal(pipeline.render_framebuffer(stale), full)


def test_pass_regime_matches_jax(monkeypatch):
    """The pass regime (``pipeline.regime_backend``) on a CUDA device resolves
    every combination of packet backend, rays per pixel, ``cull_split`` and
    cluster table size as JAX's ``_regime_scene`` resolves it on a TPU:
    ``"auto"`` becomes ``"fused1"`` for passes of 10 or more rays per pixel
    with one box a cluster and a table of at most 16 MiB, and an explicit
    backend stays. On the CPU every backend stays, and a CPU scene's pass
    keeps "auto", the xla engine, as JAX's non-TPU path does."""
    import dataclasses
    import types

    import jax
    from cuda_raytracer_tpu.models.scene import RenderConfig

    class RegimeScene:  # what _regime_scene reads of a JAX scene
        def __init__(self, config, words):
            self.config, self.cluster_blocks = config, types.SimpleNamespace(size=words)

        def replace(self, config):
            return RegimeScene(config, self.cluster_blocks.size)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    limit_words = (16 << 20) // 4
    moved = 0
    for backend in packet_intersect.BACKENDS:
        for rpp in (1, 2, 8, 9, 10, 11, 20):
            for split in (1, 2):
                for words in (1, limit_words - 1, limit_words, limit_words + 1, 4 * limit_words):
                    cfg = dataclasses.replace(RenderConfig(), packet_backend=backend,
                                              cull_split=split)
                    want = jpipeline._regime_scene(RegimeScene(cfg, words), rpp)
                    got = pipeline.regime_backend(backend, rpp, split, 4 * words, "cuda")
                    assert got == want.config.packet_backend, (backend, rpp, split, words)
                    assert pipeline.regime_backend(backend, rpp, split, 4 * words,
                                                   "cpu") == backend
                    moved += got != backend
    assert moved == 3 * 3  # "auto" at 10, 11 and 20 rays per pixel, tables up to 16 MiB
    _, ts = _both("torus")
    assert ts.config.packet_backend == "auto"
    assert pipeline._regime_scene(ts, 20) is ts


def test_regime_and_unported_paths():
    """The paths once unported run: the "cullhit" and "auto" sort keys
    reorder (a permutation of the rays) and render the Morton key's bits;
    the BVH intersector renders the packet intersector's image at the
    per-pixel gate (equal-distance ties may pick other triangles)."""
    _, ts = _both("torus")
    # "auto" is the plain xla engine on the CPU and cull + fused on the card.
    assert packet_intersect.resolve_backend("auto", ts.device) == "xla"
    assert packet_intersect.resolve_backend("auto", torch.device("cuda")) == "fused"
    ref = pipeline.render_framebuffer(ts)
    state = wavefront.make_initial_state(ts, torch.arange(64, dtype=torch.int32), 4, 0)
    for key in ("cullhit", "auto"):
        reordered = wavefront.reorder_rays(ts.with_config(sort_key=key), state)
        assert sorted(reordered.ray_id.tolist()) == list(range(64))
        assert torch.equal(pipeline.render_framebuffer(ts.with_config(sort_key=key)), ref)
    with pytest.raises(ValueError, match="sort_engine"):
        wavefront.reorder_rays(ts.with_config(sort_engine="radix"), state)
    bvh = pipeline.render_framebuffer(ts.with_config(intersector="bvh"))
    assert_pixels_agree(bvh.numpy(), ref.numpy())
