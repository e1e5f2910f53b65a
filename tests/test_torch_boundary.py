"""Boundaries of the PyTorch port: what it imports, and where it runs by default.

- Importing every module of ``cuda_raytracer_tpu_torch`` (the CLI, its
  ``__main__``, the native BVH binding, ``utils``, ``render.diff``, the
  inverse-rendering example and ``parallel`` among them) and
  ``chip_smoke.py`` in a fresh interpreter loads neither ``jax`` nor the
  JAX package ``cuda_raytracer_tpu``. The names are matched exactly or as
  ``name.`` prefixes, because the port's own name starts with the JAX
  package's.
- The entry points default to CUDA: called without ``device=`` on a machine
  with no GPU they raise instead of rendering on the CPU; so does the CLI's
  accelerator run, before it reads the scene file.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch import cli, default_device
from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.models.scene import make_materials, precompute_camera
from cuda_raytracer_tpu_torch.models.scene import scene_from_numpy, scene_to_numpy

REPO = Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, pkgutil, sys
import cuda_raytracer_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
forbidden = ("jax", "cuda_raytracer_tpu")
loaded = [m for m in sys.modules
          if any(m == f or m.startswith(f + ".") for f in forbidden)]
for name in ("render.pipeline", "render.diff", "cli", "__main__", "native.bvh_native",
             "utils.checkpoint", "utils.metrics", "ops.kernels.sweep",
             "ops.kernels.bounce", "ops.kernels.counts",
             "examples.inverse_render", "parallel.mesh", "parallel.shard"):
    assert "cuda_raytracer_tpu_torch." + name in sys.modules, name
print("FORBIDDEN", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    parsed = scene_dsl.parse_scene_text(builtin_scenes.SPHERES)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_dsl.assemble_scene(parsed)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_dsl.load_scene(str(REPO / "missing.scene"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(REPO / "missing.scene")])
    with pytest.raises(RuntimeError, match="CUDA"):
        precompute_camera([0, 0, 0], [0, 0, 1], [0, 1, 0], 1.0, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_materials(*([torch.zeros(1, 3).numpy()] * 3 + [torch.zeros(1).numpy()] * 3))
    scene = scene_dsl.assemble_scene(parsed, device="cpu")
    arrays, static = scene_to_numpy(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_from_numpy(arrays, static)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene.to(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene.to("cuda")
