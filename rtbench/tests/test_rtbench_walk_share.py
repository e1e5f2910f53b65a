"""The ``hit.walk_share`` reader (``rtbench/metrics/hit.walk_share.py``):
the share of an image's closest-hit rows that the BVH walk took, from the
program's ``hit.walk_rows`` and ``hit.rows`` counters.

It gives nothing for a trace that saw no device operation, for a program
without the registry, or for a train trace. With the registry filled by toy
CPU renders under the profiler and a stand-in device event list, it gives 1
through the walk and 0 through the packet intersector (the CPU's "auto").
"""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from rtbench.tests.test_rtbench_program_metrics import (STAND_IN, UNITS, _fill,
                                                        _reader, _torus, _trace)

NAME = "hit.walk_share"


def _images(intersector: str):
    from cuda_raytracer_tpu_torch.render import pipeline

    scene = _torus(width=8, height=8, rays_per_pixel=4, intersector=intersector)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(UNITS):
            pipeline.render_image(scene, framebuffer=pipeline.render_framebuffer(scene))


@pytest.fixture(scope="module")
def registries():
    return {mode: _fill(lambda: _images(mode)) for mode in ("bvh", "packet")}


@pytest.fixture
def use(monkeypatch):
    """Make a filled registry the process-wide one for the test."""
    from cuda_raytracer_tpu_torch.utils import metrics

    def put(registry):
        monkeypatch.setattr(metrics, "PROFILED", registry)
        return registry
    return put


def test_nothing_without_device_events(registries, use):
    use(registries["bvh"])
    for kind in ("image", "train"):
        assert _reader(NAME).read(_trace(kind, [])) is None


def test_nothing_from_a_program_without_the_registry(monkeypatch):
    from cuda_raytracer_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "PROFILED")
    for kind in ("image", "train"):
        assert _reader(NAME).read(_trace(kind, STAND_IN)) is None


@pytest.mark.parametrize("mode,want", [("bvh", 1.0), ("packet", 0.0)])
def test_walk_share(registries, use, mode, want):
    """1 where the walk took every closest-hit row (``intersector="bvh"``),
    0 where the packet intersector took them."""
    assert use(registries[mode]).counters["hit.rows"] > 0
    assert _reader(NAME).read(_trace("image", STAND_IN)) == want
    assert _reader(NAME).read(_trace("train", STAND_IN)) is None
