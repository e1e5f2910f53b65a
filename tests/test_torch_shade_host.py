"""The CUDA shade kernel's source, compiled for the host, against its plain version.

``cuda_raytracer_tpu_torch/csrc/shade.cu`` runs only on the GPU, where
``chip_smoke.py`` holds it against the plain PyTorch path. Its per-ray
arithmetic is plain C++, though, so this test also compiles the same source
with the host C++ compiler (through a small shim standing in for the CUDA
runtime, with ``-ffp-contract=off`` like the GPU build's ``-fmad=false``),
runs the grid as a loop, and holds every ray's radiance against
``shade.plain_trace`` under the repo's agreement gate. It catches a
transcription fault in the kernel on a machine with no GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import build, shade

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
using std::sqrt;
struct float4 { float x, y, z, w; };
struct Index { unsigned x; };
static Index threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
static inline void __syncthreads() {}
static inline int cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
alignas(16) static float4 host_smem[1 << 12];
"""

LAUNCH = "  shade_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>("
HOST_LAUNCH = """  blockDim.x = kThreads;
  std::copy(table, table + smem / sizeof(float), reinterpret_cast<float*>(host_smem));
  for (blockIdx.x = 0; blockIdx.x < (unsigned)blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < (unsigned)kThreads; ++threadIdx.x)
      shade_kernel("""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (build.CSRC_DIR / "shade.cu").read_text()
    for needle in ("#include <cuda_runtime.h>", "extern __shared__ float4 smem4[];", LAUNCH):
        assert needle in src, f"host shim no longer matches shade.cu: {needle!r}"
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = src.replace("extern __shared__ float4 smem4[];", "float4* smem4 = host_smem;")
    src = src.replace(LAUNCH, HOST_LAUNCH)
    out = tmp_path_factory.mktemp("shade_host")
    (out / "shim.h").write_text(SHIM)
    (out / "shade_host.cpp").write_text(src)
    lib_path = out / "libshade_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib_path), str(out / "shade_host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.rt_shade_trace.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_uint, ctypes.c_void_p]
    )
    lib.rt_shade_trace.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name", ["cornell", "cornell_plus", "spheres"])
@pytest.mark.parametrize("lo,n,rpp,bounces,seed", [(0, 16 * 16 * 4, 4, 10, 3),
                                                   (100, 260, 2, 3, 1)])
def test_host_compiled_kernel_matches_plain(host_kernel, name, lo, n, rpp, bounces, seed):
    scene = scene_dsl.assemble_scene(
        scene_dsl.parse_scene_text(builtin_scenes.SCENES[name]),
        config_overrides=dict(width=16, height=16), device="cpu",
    )
    ray_id = lo + torch.arange(n, dtype=torch.int32)
    ref = shade.plain_trace(scene, ray_id, rpp, seed, bounces).numpy()
    table = shade.pack_table(scene)
    out = torch.empty((n, 3), dtype=torch.float32)
    err = host_kernel.rt_shade_trace(
        table.data_ptr(), ray_id.data_ptr(), out.data_ptr(), n, rpp,
        scene.config.width, bounces, scene.sphere_count, scene.triangle_count,
        scene.material_count, seed, None,
    )
    assert err == 0
    got = out.numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - ref).max(axis=1)
    # Agreement gate: libm sin/cos may differ from torch's by ulps.
    assert (diff < 1e-3).mean() >= 0.999, (name, diff.max())
