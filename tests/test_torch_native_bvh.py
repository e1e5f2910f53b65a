"""The port's native (C++) BVH builder against the JAX package's NumPy builder.

The same triangles, made with numpy, go through JAX's ``build_bvh_numpy``
(the oracle) and the port's ``build_bvh``, which compiles
``native/bvh_builder.cpp`` with g++ at first use. Every array is EQUAL: the
builder computes in double precision in the same order and rounds to
float32 once, as the NumPy builder does.
"""

import numpy as np
import pytest

from cuda_raytracer_tpu.models import bvh as jbvh

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import bvh
from cuda_raytracer_tpu_torch.native import bvh_native
from cuda_raytracer_tpu_torch.ops.kernels import build


def _triangles(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, (n, 1, 3))
    pts = (centres + rng.normal(scale=0.5, size=(n, 3, 3))).astype(np.float32)
    return pts[:, 0], pts[:, 1], pts[:, 2]


def _assert_equal(got, want):
    for name in ("node_min", "node_max", "child1", "child2", "order"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.max_leaf_size == want.max_leaf_size


@pytest.mark.parametrize("n,max_depth", [(10, 30), (500, 30), (5000, 30), (300, 0)])
def test_native_equals_jax_numpy_builder(n, max_depth):
    p1, p2, p3 = _triangles(n, seed=n)
    got = bvh.build_bvh(p1, p2, p3, max_depth=max_depth)  # native by default
    _assert_equal(got, jbvh.build_bvh_numpy(p1, p2, p3, max_depth))
    assert bvh.validate_bvh(got, n) is None
    if max_depth == 0:  # the no_bvh mode: one leaf over every triangle
        assert got.child1.shape == (1,) and got.max_leaf_size == n
    else:
        assert got.child1.shape[0] > 1


def test_numpy_path_and_build_cache():
    p1, p2, p3 = _triangles(200, seed=3)
    _assert_equal(bvh.build_bvh(p1, p2, p3, prefer_native=False),
                  jbvh.build_bvh_numpy(p1, p2, p3))
    empty = np.zeros((0, 3), np.float32)
    _assert_equal(bvh.build_bvh(empty, empty, empty), jbvh.build_bvh_numpy(empty, empty, empty))
    # The library sits in _build/, its name keyed by the source and flags.
    bvh_native.library()
    digest = build.source_digest(bvh_native.SOURCE, bvh_native.CXX_FLAGS)
    assert (build.BUILD_DIR / f"libbvh_builder-{digest}.so").exists()


def test_failed_native_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        build.compile_library(bad, "broken", bvh_native.CXX_FLAGS, bvh_native.cxx_path)
    assert not list(build.BUILD_DIR.glob("libbroken-*"))
