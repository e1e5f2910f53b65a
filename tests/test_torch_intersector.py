"""Which triangle intersector a scene resolves to, and the closest hit's counters.

``render/wavefront.resolve_intersector`` is a pure function of the mode,
the triangle count, the tree's node count and the device type: on the CPU
it is the JAX package's rule (held to ``resolved_intersector`` of
``cuda_raytracer_tpu/render/wavefront.py`` case by case), on a CUDA device
"auto" takes the BVH walk above 512 triangles. While a registry is
attached, ``hit.rows`` counts the rows handed to a triangle closest hit and
``hit.walk_rows`` those the walk took.
"""

import types

import pytest

from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.render import pipeline, wavefront
from cuda_raytracer_tpu_torch.utils import metrics

MODES = ("auto", "brute", "packet", "bvh")


def _jax_rule(mode: str, triangles: int, nodes: int) -> str:
    scene = types.SimpleNamespace(config=types.SimpleNamespace(intersector=mode),
                                  triangle_count=triangles, bvh_node_count=nodes)
    return jwavefront.resolved_intersector(scene)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nodes", [1, 463])
@pytest.mark.parametrize("triangles", [0, 512, 513])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_intersector(device, triangles, nodes, mode):
    got = wavefront.resolve_intersector(mode, triangles, nodes, device)
    if device == "cpu":
        assert got == _jax_rule(mode, triangles, nodes)
    if nodes == 1 or triangles == 0:
        assert got == "brute"
    elif mode != "auto":
        assert got == mode  # an explicit mode is never overridden
    elif triangles <= wavefront.BRUTE_MAX_TRIANGLES:
        assert got == "brute"
    else:
        assert got == ("bvh" if device == "cuda" else "packet")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_unknown_intersector_raises(device):
    with pytest.raises(ValueError, match="unknown intersector"):
        wavefront.resolve_intersector("clustered", 126_000, 463, device)


def _torus(**cfg):
    parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
    return scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=8, height=8, rays_per_pixel=2, bounces=3, **cfg),
        device="cpu")


def test_cpu_auto_keeps_the_packet_intersector():
    scene = _torus()
    assert scene.triangle_count > wavefront.BRUTE_MAX_TRIANGLES
    assert wavefront.resolved_intersector(scene) == "packet"
    assert wavefront.resolve_intersector("auto", scene.triangle_count,
                                         scene.bvh_node_count, "cuda") == "bvh"


@pytest.mark.parametrize("intersector", ["bvh", "packet"])
def test_hit_counters(intersector):
    """Every row of a closest hit counts in ``hit.rows``; the walk's also in
    ``hit.walk_rows``. Recording leaves the framebuffer's bits alone."""
    scene = _torus(intersector=intersector)
    m = metrics.Metrics()
    fb = pipeline.render_framebuffer(scene, metrics=m)
    assert (fb == pipeline.render_framebuffer(scene)).all()
    counters = m.resolve().counters
    # bounce 0 hands every camera ray to the closest hit
    assert counters["hit.rows"] >= scene.num_pixels * 2
    walked = counters.get("hit.walk_rows", 0)
    assert walked == (counters["hit.rows"] if intersector == "bvh" else 0)
