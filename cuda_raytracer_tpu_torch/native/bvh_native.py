"""ctypes binding of the C++ BVH builder (``native/bvh_builder.cpp``).

Counterpart of ``cuda_raytracer_tpu/native/bvh_native.py``. The library is
compiled with the host C++ compiler at first use into
``cuda_raytracer_tpu_torch/_build/``, its name keyed by a hash of the source
and the flags (``ops/kernels/build.compile_library``), so an edited source
rebuilds and an unchanged one loads at once. Unlike the JAX package this
binding has no silent fallback: a missing compiler, a failed build or a
failed load raises, and ``models/bvh.build_bvh(prefer_native=False)`` is how
a caller asks for the NumPy builder.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import numpy as np

from cuda_raytracer_tpu_torch.ops.kernels import build

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
# No multiply-add contraction, as in every other native build of the port.
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def cxx_path() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError(
            "no host C++ compiler (g++ or c++ on PATH); the native BVH builder is "
            "compiled at first use"
        )
    return found


def library() -> ctypes.CDLL:
    """Build (at first use) and bind the builder."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build.compile_library(SOURCE, "bvh_builder", CXX_FLAGS, cxx_path).lib
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lp = ctypes.POINTER(ctypes.c_int64)
            lib.crt_build_bvh.restype = ctypes.c_int
            lib.crt_build_bvh.argtypes = [
                fp, fp, fp, ctypes.c_int64, ctypes.c_int,  # p1 p2 p3, count, depth
                fp, fp, ip, ip, ip,  # node min / max, child1 / child2, order
                lp, lp,  # node count, largest leaf
            ]
            _lib = lib
        return _lib


def build_bvh_native(p1, p2, p3, max_depth: int):
    """Build a BVH with the C++ builder → ``models.bvh.BvhArrays``, equal
    array for array to ``build_bvh_numpy`` on the same triangles."""
    from cuda_raytracer_tpu_torch.models.bvh import BvhArrays

    lib = library()
    tri_count = int(p1.shape[0])
    p1, p2, p3 = (np.ascontiguousarray(p, np.float32).reshape(tri_count, 3)
                  for p in (p1, p2, p3))
    cap = 2 * tri_count + 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    child1 = np.empty(cap, np.int32)
    child2 = np.empty(cap, np.int32)
    order = np.empty(tri_count, np.int32)
    node_count = ctypes.c_int64()
    max_leaf = ctypes.c_int64()
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    status = lib.crt_build_bvh(
        p1.ctypes.data_as(fp), p2.ctypes.data_as(fp), p3.ctypes.data_as(fp),
        tri_count, max_depth,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        child1.ctypes.data_as(ip), child2.ctypes.data_as(ip), order.ctypes.data_as(ip),
        ctypes.byref(node_count), ctypes.byref(max_leaf),
    )
    if status != 0:
        raise RuntimeError(f"native BVH build failed with status {status}")
    n = node_count.value
    return BvhArrays(
        node_min=node_min[:n].copy(),
        node_max=node_max[:n].copy(),
        child1=child1[:n].copy(),
        child2=child2[:n].copy(),
        order=order,
        max_leaf_size=int(max_leaf.value),
    )
