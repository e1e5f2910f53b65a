"""Scene model and loaders of the PyTorch port against the JAX package.

Parsing, the BVH build, the cluster cut and padding are the JAX package's
NumPy code, copied, so every array the port assembles must EQUAL the JAX
scene's, bit for bit, and the parse errors must carry the same file:line
diagnostics.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.models import bvh as jbvh
from cuda_raytracer_tpu.models import cluster as jcluster
from cuda_raytracer_tpu.models import scene_dsl as jdsl

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.models import bvh as tbvh
from cuda_raytracer_tpu_torch.models import cluster as tcluster
from cuda_raytracer_tpu_torch.models import scene_dsl as tdsl
from cuda_raytracer_tpu_torch.models.scene import scene_from_numpy, scene_to_numpy

# Two extra shapes beside the built-in scenes: a textured-sky-free scene
# with triangles and spheres mixed, and an empty (sky only) scene.
MIXED = """
material a diffuse 0.5 0.2 0.1 roughness 0.3
material b specular 0.9 0.9 0.9 metallicity 0.7
sphere b 0 1 3 1
triangle a -2 0 2  2 0 2  0 3 5
quad a -5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5
camera position 0 1 -4 forward 0 0 1 up 0 1 0 fov 55
image 12 10 3 4 1
"""
EMPTY = "sky 0.3 0.5 0.8\nimage 4 4 1 2 1\n"
TEXTS = dict(builtin_scenes.SCENES, mixed=MIXED, empty=EMPTY)


def jax_scene_numpy(js):
    """A JAX ``Scene`` as (arrays, static) in the layout scene_from_numpy
    takes: tensor leaves by field name, nested ones as ``materials.<f>`` /
    ``camera.<f>``, static fields with ``config`` as a dict."""
    arrays, static = {}, {}
    for f in dataclasses.fields(js):
        value = getattr(js, f.name)
        if f.name in ("materials", "camera"):
            for g in dataclasses.fields(value):
                leaf = getattr(value, g.name)
                if g.name == "vertical_fov":
                    static["camera.vertical_fov"] = leaf
                else:
                    arrays[f"{f.name}.{g.name}"] = np.asarray(leaf)
        elif f.name == "config":
            static["config"] = dataclasses.asdict(value)
        elif f.metadata.get("static"):
            static[f.name] = value
        else:
            arrays[f.name] = np.asarray(value)
    return arrays, static


def build_both(text, overrides=None, use_bvh=True):
    """The same DSL text assembled by the JAX package and by the port (CPU)."""
    js = jdsl.assemble_scene(
        jdsl.parse_scene_text(text), use_bvh=use_bvh,
        config_overrides=overrides, prefer_native_bvh=False,
    )
    ts = tdsl.assemble_scene(
        tdsl.parse_scene_text(text), use_bvh=use_bvh,
        config_overrides=overrides, prefer_native_bvh=False, device="cpu",
    )
    return js, ts


@pytest.mark.parametrize("use_bvh", [True, False])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_assemble_scene_arrays_equal_jax(name, use_bvh):
    js, ts = build_both(TEXTS[name], dict(width=8, height=6), use_bvh=use_bvh)
    j_arrays, j_static = jax_scene_numpy(js)
    t_arrays, t_static = scene_to_numpy(ts)
    assert sorted(j_arrays) == sorted(t_arrays)
    for key, ref in j_arrays.items():
        got = t_arrays[key]
        assert got.dtype == ref.dtype, key
        assert got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    assert t_static == j_static


def test_scene_from_numpy_roundtrip():
    js, ts = build_both(builtin_scenes.CORNELL_PLUS, dict(width=8, height=8))
    arrays, static = jax_scene_numpy(js)
    carried = scene_from_numpy(arrays, static, device="cpu")
    assert carried.device == torch.device("cpu")
    a, s = scene_to_numpy(carried)
    b, t = scene_to_numpy(ts)
    assert s == t
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    moved = carried.to("cpu")
    assert moved.materials.emitted.device.type == "cpu"
    assert moved.with_config(bounces=2).config.bounces == 2


def test_render_config_fields_and_defaults_match_jax():
    from cuda_raytracer_tpu.models.scene import RenderConfig as JaxConfig
    from cuda_raytracer_tpu_torch.models.scene import RenderConfig

    assert dataclasses.asdict(RenderConfig()) == dataclasses.asdict(JaxConfig())


def test_bvh_and_clusters_equal_jax():
    rng = np.random.default_rng(5)
    p1 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p2 = p1 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    p3 = p1 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    jb = jbvh.build_bvh_numpy(p1, p2, p3)
    tb = tbvh.build_bvh(p1, p2, p3, prefer_native=True)
    for f in ("node_min", "node_max", "child1", "child2", "order"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    assert tb.max_leaf_size == jb.max_leaf_size
    assert tbvh.validate_bvh(tb, 300) is None
    jc = jcluster.build_clusters(jb, 300, max_tris=32)
    tc = tcluster.build_clusters(tb, 300, max_tris=32)
    for f in ("start", "count", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)


def test_parse_error_diagnostics_match_jax():
    cases = [
        ("material m\nsphere ghost 0 0 0 1\n", "demo.scene"),
        ("material m\nsphere m 0 0 banana 1\n", "demo.scene"),
        ("triangle nope 0 0 0\n", "<scene>"),
        ("camera position 0 0\n", "<scene>"),
        ("material m\nquad m 0 0 0 1 1\n", "<scene>"),
    ]
    for text, filename in cases:
        with pytest.raises(jdsl.SceneParseError) as jerr:
            jdsl.parse_scene_text(text, filename=filename)
        with pytest.raises(tdsl.SceneParseError) as terr:
            tdsl.parse_scene_text(text, filename=filename)
        assert str(terr.value) == str(jerr.value)
        assert ":" in str(terr.value) and filename in str(terr.value)


def test_load_scene_from_file(tmp_path):
    path = tmp_path / "cornell.scene"
    path.write_text(builtin_scenes.CORNELL)
    scene = tdsl.load_scene(str(path), config_overrides=dict(width=8, height=8),
                            device="cpu")
    assert scene.triangle_count == 32 and scene.sphere_count == 0
    assert scene.material_count == 4
    assert scene.config.bounces == 10 and scene.config.exposure == 1.0
