"""The port's checkpoint / resume and metrics against the JAX package's.

- A checkpoint file written by either package loads in the other with the
  same values and types (same ``.npz`` keys), and the two packages give the
  same scene the same fingerprint.
- A render stopped after two passes and resumed from its checkpoint is
  BIT-IDENTICAL to an uninterrupted one (pass seeds derive from the
  remaining-sample count), on a brute scene and on a mesh scene.
- A resumed render re-enforces the suspect count its checkpoint carries.
- ``Metrics`` keeps the JAX registry's fields and JSON line.
"""

import io
import json

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.models import scene_dsl as jdsl
from cuda_raytracer_tpu.utils import checkpoint as jckpt
from cuda_raytracer_tpu.utils import metrics as jmetrics

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.render import pipeline
from cuda_raytracer_tpu_torch.utils import checkpoint as ckpt
from cuda_raytracer_tpu_torch.utils import metrics

OVERRIDES = dict(width=8, height=8, rays_per_pixel=6, bounces=2,
                 max_rays_per_pixel_per_pass=2)


def _scene(name):
    if name == "cornell":
        parsed = scene_dsl.parse_scene_text(builtin_scenes.CORNELL)
    else:
        parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
    return scene_dsl.assemble_scene(parsed, config_overrides=OVERRIDES, device="cpu")


def test_checkpoint_files_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    fb = rng.uniform(size=(64, 3)).astype(np.float32)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(a, fb, 4, "f1", suspects=3)
    ckpt.save_checkpoint(b, fb, 4, "f1", suspects=3)
    for path in (a, b):
        for load in (ckpt.load_checkpoint, jckpt.load_checkpoint):
            got = load(path, "f1")
            assert got[0].dtype == np.float32 and np.array_equal(got[0], fb)
            assert got[1:] == (4, 3)
            assert load(path, "other") is None
    with np.load(a) as ja, np.load(b) as pa:
        assert sorted(ja.files) == sorted(pa.files)
        for key in ja.files:
            assert ja[key].dtype == pa[key].dtype and np.array_equal(ja[key], pa[key])
    assert ckpt.load_checkpoint(str(tmp_path / "missing.npz"), "f1") is None
    # The same scene text gives the same fingerprint in both packages.
    text = builtin_scenes.CORNELL
    js = jdsl.assemble_scene(jdsl.parse_scene_text(text), config_overrides=OVERRIDES)
    ts = scene_dsl.assemble_scene(scene_dsl.parse_scene_text(text),
                                  config_overrides=OVERRIDES, device="cpu")
    assert ckpt.scene_fingerprint(ts) == jckpt.scene_fingerprint(js)
    assert ckpt.scene_fingerprint(ts.with_config(width=9)) != ckpt.scene_fingerprint(ts)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["cornell", "torus"])
def test_resume_bit_identical(tmp_path, name):
    scene = _scene(name)
    straight = pipeline.render_framebuffer(scene)
    path = str(tmp_path / "render.npz")

    def stop_after_two_passes(done, total):
        assert total == 6
        if done == 4:
            raise _Stop

    with pytest.raises(_Stop):
        pipeline.render_framebuffer(scene, checkpoint_path=path,
                                    progress=stop_after_two_passes)
    assert ckpt.load_checkpoint(path, ckpt.scene_fingerprint(scene))[1:] == (4, 0)
    m = metrics.Metrics()
    resumed = pipeline.render_framebuffer(scene, checkpoint_path=path, metrics=m)
    assert torch.equal(resumed, straight)
    assert m.series == {"samples_done": [6.0], "suspect_rays": [0.0]}  # one pass ran
    assert ckpt.load_checkpoint(path, ckpt.scene_fingerprint(scene))[1] == 6


def test_resume_reenforces_persisted_suspects(tmp_path):
    scene = _scene("cornell")
    path = str(tmp_path / "render.npz")
    fb = pipeline.render_framebuffer(scene)
    ckpt.save_checkpoint(path, fb.numpy(), 6, ckpt.scene_fingerprint(scene), suspects=5)
    with pytest.raises(RuntimeError, match="exactness certificate"):
        pipeline.render_framebuffer(scene, checkpoint_path=path, auto_retry=False)


def test_metrics_match_jax_registry():
    lines = []
    for module in (jmetrics, metrics):
        m = module.Metrics()
        with m.phase("build"):
            pass
        m.count("rays", 100)
        m.count("rays", 50)
        m.record("live", 0.5)
        m.phases["render"] = 2.0
        assert m.throughput("paths", 10.0, "render") == 5.0
        assert m.throughput("paths", 10.0, "missing") is None
        m.phases["build"] = 0.0  # the one wall-clock value
        stream = io.StringIO()
        line = m.emit(stream=stream, scene="s")
        assert stream.getvalue() == line + "\n"
        lines.append(json.loads(line))
    assert lines[0] == lines[1]
