"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in the package only, into
``cuda_raytracer_tpu_torch/_build/`` (listed in ``.gitignore``); the library
name carries a hash of the source, every header it includes from ``csrc/``
(``#include "x.cuh"``, followed recursively) and the flags, so an edited
source or shared header rebuilds and an unchanged one loads at once.
``compile_library`` builds the host BVH builder (``native/``, g++) the same
way.

Numerics flags: no ``--use_fast_math`` (IEEE division and square root,
accurate sin/cos) and ``-fmad=false`` (no multiply-add contraction), so the
kernels round like the plain PyTorch versions they are held against.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time, 0.0 when an existing build was loaded
    log: str  # nvcc / ptxas output of the compile ("" when loaded)


_LOADED: Dict[str, Built] = {}

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of ``source``, the local headers it includes (recursively, each
    once, resolved beside the including file) and the compiler flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    seen, todo = set(), [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for name in _LOCAL_INCLUDE.findall(text.decode()):
            todo.append((path.parent / name).resolve())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def compile_library(
    source: Path, stem: str, flags: Sequence[str], compiler: Callable[[], str]
) -> Built:
    """Load ``_build/lib<stem>-<digest>.so``, compiling ``source`` with
    ``compiler()`` (called only when a build is needed) and ``flags`` first
    if it is not there. The library is written under a temporary name and
    renamed, so concurrent builds never load a partial file. A failed
    compile raises."""
    digest = source_digest(source, flags)
    target = BUILD_DIR / f"lib{stem}-{digest}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(partial), str(source)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"{cmd[0]} failed for {source}:\n{log}")
        os.replace(partial, target)
    return Built(ctypes.CDLL(str(target)), target, seconds, log)


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` with nvcc if needed and load it (cached per
    process)."""
    if name not in _LOADED:
        _LOADED[name] = compile_library(CSRC_DIR / f"{name}.cu", name, NVCC_FLAGS, nvcc_path)
    return _LOADED[name]


def load_all(names: Sequence[str]) -> Dict[str, Built]:
    """``load`` every name at once: one nvcc per source, all started
    together (each waits in its own thread), so the builds overlap."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
