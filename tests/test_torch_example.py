"""The port's inverse-rendering example runs on the CPU and learns.

``python -m cuda_raytracer_tpu_torch.examples.inverse_render`` recovers the
Cornell box's red and green walls from a target image; at its default size
(64×64, 8 rays per pixel, 60 steps) it must land within 0.15 of the true
albedos, which ``chip_smoke.py`` checks on the GPU. Here it runs at a tiny
size (16×16, 4 rays per pixel, 15 steps) on the CPU: the loss must fall, and
the command-line entry point must write its three images.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.examples import inverse_render

REPO = Path(__file__).resolve().parents[1]


def test_inverse_render_loss_falls():
    lines = []
    result = inverse_render.run(size=16, spp=4, steps=15, device="cpu", log=lines.append)
    losses = result["losses"]
    assert len(losses) == 15 and losses[-1] < 0.5 * losses[0], losses
    assert result["err"] < 0.5 and any("coloured walls" in line for line in lines)


def test_inverse_render_command_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_raytracer_tpu_torch.examples.inverse_render", "--cpu",
         "--size", "12", "--spp", "2", "--steps", "3", "--bounces", "3",
         "--out", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode in (0, 1), proc.stderr  # 1: three steps miss the bar
    assert "mean |error| on coloured walls" in proc.stdout
    for name in ("target.png", "initial.png", "recovered.png"):
        assert (tmp_path / name).stat().st_size > 0
