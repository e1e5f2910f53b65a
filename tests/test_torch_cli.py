"""The port's command-line renderer against the JAX package's.

Both CLIs render the same Cornell scene file on the CPU (``cpu no_gpu``) at
16×16, 2 rays per pixel and 2 bounces. The two PNGs are expected to be
identical; the gate allows what the repo's render parity allows, at most 1
per channel on >= 99.9 % of the bytes (libm sin/cos may differ by ulps).
The exit codes for a missing scene argument, an unknown flag and no backend
equal JAX's. Without CUDA the accelerator run raises instead of rendering
on the CPU, and so does ``--mesh`` unless ``cpu no_gpu`` asks for CPU ranks
(``test_torch_parallel.py`` runs those). ``--mesh 1`` renders in the calling
process, as the JAX CLI does, and writes the plain run's PNG bytes. The
packet intersector's options, given for a scene that resolves to another
intersector, are named in a warning.
"""

import multiprocessing.process
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu import cli as jcli

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch import cli
from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.utils.png import read_png

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--width", "16", "--height", "16", "--spp", "2", "--bounces", "2"]


@pytest.fixture
def cornell(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_RAYTRACER_TPU_NO_CACHE", "1")  # no JAX compile cache
    path = tmp_path / "cornell.scene"
    path.write_text(builtin_scenes.CORNELL)
    return path


def test_cpu_render_matches_jax_cli(cornell, tmp_path):
    port, ref = tmp_path / "port.png", tmp_path / "jax.png"
    assert cli.main([str(cornell), "cpu", "no_gpu", *SMALL, "--out", str(port)]) == 0
    assert jcli.main([str(cornell), "cpu", "no_gpu", *SMALL, "--out", str(ref)]) == 0
    a = read_png(str(port)).astype(np.int32)
    b = read_png(str(ref)).astype(np.int32)
    assert a.shape == b.shape == (16, 16, 3)
    assert float((np.abs(a - b) <= 1).mean()) >= 0.999
    assert 5.0 < a.mean() < 250.0


def test_exit_codes_equal_jax(cornell):
    for argv, code in (([], 1), ([str(cornell), "bogus_flag"], 1), ([str(cornell), "no_gpu"], 2)):
        assert cli.main(argv) == jcli.main(argv) == code, argv


def test_accelerator_and_mesh_refused_without_support(cornell):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the accelerator run is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(cornell), *SMALL])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(cornell), "cpu", *SMALL])  # both backends: the GPU is required
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(cornell), "--mesh", "1", *SMALL])


def test_module_entry_point(tmp_path):
    """``python -m cuda_raytracer_tpu_torch`` on a mesh scene with
    ``--cull-hier`` (too few boxes to gate: the flat cull runs), a
    checkpoint and metrics."""
    scene = tmp_path / "torus.scene"
    scene.write_text(builtin_scenes.torus(builtin_scenes.SMALL) + "sky_map envmap.pfm\n")
    out, check = tmp_path / "t.png", tmp_path / "t.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_raytracer_tpu_torch", str(scene), "cpu", "no_gpu",
         *SMALL, "--cull-hier", "16", "--checkpoint", str(check), "--metrics",
         "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "paths/s" in proc.stderr and '"load_scene"' in proc.stderr
    assert read_png(str(out)).shape == (16, 16, 3)
    with np.load(check) as data:
        assert int(data["samples_done"]) == 2


def test_mesh_1_renders_in_process(cornell, tmp_path, monkeypatch):
    """``cpu no_gpu --mesh 1``: no child process is started (spawning one
    fails the test), and the PNG equals the plain run's byte for byte."""
    def refuse(*args, **kwargs):
        raise AssertionError("--mesh 1 started a child process")

    plain, mesh = tmp_path / "plain.png", tmp_path / "mesh1.png"
    assert cli.main([str(cornell), "cpu", "no_gpu", *SMALL, "--out", str(plain)]) == 0
    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(torch.multiprocessing, "start_processes", refuse)
    assert cli.main([str(cornell), "cpu", "no_gpu", *SMALL, "--mesh", "1", "--metrics",
                     "--out", str(mesh)]) == 0
    assert mesh.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("name, resolved", [("cornell", "brute"), ("torus", "packet")])
def test_packet_options_warn_when_unused(name, resolved, tmp_path, capsys):
    """``--cull-hier`` and ``--packet-tile`` on the CPU: the Cornell box
    resolves to brute and gets a warning that names both; the small torus
    (768 triangles) resolves to the packet intersector and gets none."""
    scene = tmp_path / f"{name}.scene"
    scene.write_text(builtin_scenes.CORNELL if name == "cornell"
                     else builtin_scenes.torus(builtin_scenes.SMALL) + "sky_map envmap.pfm\n")
    assert cli.main([str(scene), "cpu", "no_gpu", *SMALL, "--cull-hier", "16",
                     "--packet-tile", "32", "--out", str(tmp_path / "x.png")]) == 0
    warnings = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("Warning:")]
    if resolved == "packet":
        assert warnings == []
    else:
        assert len(warnings) == 1
        assert "--packet-tile --cull-hier" in warnings[0] and "'brute' on cpu" in warnings[0]
