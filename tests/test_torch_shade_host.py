"""The CUDA shade kernel's per-path step, compiled for the host, against its plain version.

``cuda_raytracer_tpu_torch/csrc/shade.cu`` runs only on the GPU, where
``chip_smoke.py`` holds it against the plain PyTorch path. Its per-path
arithmetic (camera ray, closest hit, the shading it shares with the bounce
kernel) is ``rt::brute`` in ``csrc/brute.cuh`` on ``csrc/shading.cuh``, and
``csrc/shade_host.cpp`` runs that step with the card's path regeneration
played as lanes on the host. This test builds that file with the host C++
compiler (``-ffp-contract=off`` like the GPU build's ``-fmad=false``) and
holds every ray's radiance against ``shade.plain_trace`` under the repo's
agreement gate, and the output at several lane counts to the same bits
(a path's radiance depends on its ray id only, not on the schedule). It
catches a transcription fault in the kernel on a machine with no GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import build, shade


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = tmp_path_factory.mktemp("shade_host") / "libshade_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib_path), str(build.CSRC_DIR / "shade_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.rt_host_shade_trace.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_uint, ctypes.c_int]
    )
    lib.rt_host_shade_trace.restype = ctypes.c_int
    return lib


def _scene(name):
    return scene_dsl.assemble_scene(
        scene_dsl.parse_scene_text(builtin_scenes.SCENES[name]),
        config_overrides=dict(width=16, height=16), device="cpu",
    )


def _host_trace(lib, scene, ray_id, rpp, bounces, seed, lanes):
    table = shade.pack_table(scene)
    out = torch.full((ray_id.shape[0], 3), float("nan"), dtype=torch.float32)
    err = lib.rt_host_shade_trace(
        table.data_ptr(), ray_id.data_ptr(), out.data_ptr(), ray_id.shape[0], rpp,
        scene.config.width, bounces, scene.sphere_count, scene.triangle_count,
        scene.material_count, seed, lanes,
    )
    assert err == 0
    return out


@pytest.mark.parametrize("name", ["cornell", "cornell_plus", "spheres"])
@pytest.mark.parametrize("lo,n,rpp,bounces,seed", [(0, 16 * 16 * 4, 4, 10, 3),
                                                   (100, 260, 2, 3, 1)])
def test_host_compiled_kernel_matches_plain(host_kernel, name, lo, n, rpp, bounces, seed):
    scene = _scene(name)
    ray_id = lo + torch.arange(n, dtype=torch.int32)
    ref = shade.plain_trace(scene, ray_id, rpp, seed, bounces).numpy()
    got = _host_trace(host_kernel, scene, ray_id, rpp, bounces, seed, lanes=32).numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - ref).max(axis=1)
    # Agreement gate: libm sin/cos may differ from torch's by ulps.
    assert (diff < 1e-3).mean() >= 0.999, (name, diff.max())


@pytest.mark.parametrize("name", ["cornell_plus", "spheres"])
def test_host_paths_independent_of_lanes(host_kernel, name):
    """Path regeneration: one path after another, 7 and 32 lanes in flight
    (paths of one round at different bounces), the same bits; shuffled ray
    ids give each ray its own radiance wherever it lies."""
    scene = _scene(name)
    ray_id = 7 + torch.arange(600, dtype=torch.int32)
    runs = [_host_trace(host_kernel, scene, ray_id, 3, 10, 5, lanes) for lanes in (1, 7, 32)]
    for other in runs[1:]:
        assert torch.equal(other, runs[0])
    perm = torch.from_numpy(np.random.default_rng(0).permutation(600))
    shuffled = _host_trace(host_kernel, scene, ray_id[perm].contiguous(), 3, 10, 5, 32)
    assert torch.equal(shuffled, runs[0][perm])


def test_host_zero_bounces_is_black(host_kernel):
    scene = _scene("cornell")
    ray_id = torch.arange(70, dtype=torch.int32)
    got = _host_trace(host_kernel, scene, ray_id, 2, 0, 1, lanes=32)
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(got, shade.plain_trace(scene, ray_id, 2, 1, 0))
