#!/usr/bin/env python3
"""Compare two checkouts' CUDA kernels instruction for instruction (SASS).

    python3 chip_sass.py OLD_TREE NEW_TREE [SOURCE ...]

compiles each ``cuda_raytracer_tpu_torch/csrc/<source>.cu`` of both trees to a
cubin with the port's own nvcc flags (``ops/kernels/build.NVCC_FLAGS`` of
NEW_TREE, less the shared-library ones), disassembles it with ``cuobjdump
-sass`` and prints one line per kernel: ``identical`` when the two trees'
instructions are the same (addresses and the anonymous namespace's hash
left out), else how many instructions each has. With no SOURCE, every
``.cu`` of NEW_TREE. Needs ``nvcc`` and ``cuobjdump`` (CUDA toolkit), no GPU.
A kernel that compiles to the same SASS in both trees does the same device
work, so a difference in a timing between them is not that kernel's.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

TOOLKIT = Path("/usr/local/cuda/bin")


def nvcc_flags(tree: Path):
    sys.path.insert(0, str(tree))
    from cuda_raytracer_tpu_torch.ops.kernels import build

    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                      "-Xptxas", "-v")]
    return flags


def kernels(tree: Path, source: str, flags, workdir: Path) -> dict:
    """{kernel name: [instructions]} of one source of one tree."""
    cubin = workdir / f"{abs(hash(str(tree)))}_{source}.cubin"
    subprocess.run([str(TOOLKIT / "nvcc"), *flags, "-cubin", "-o", str(cubin),
                    str(tree / "cuda_raytracer_tpu_torch" / "csrc" / f"{source}.cu")],
                   check=True, capture_output=True)
    sass = subprocess.run([str(TOOLKIT / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "(anonymous)",
                          m.group(1))
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name].append(re.sub(r"/\*.*?\*/", "", line).strip())
    return out


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()
    sources = sys.argv[3:] or sorted(p.stem for p in (
        new / "cuda_raytracer_tpu_torch" / "csrc").glob("*.cu"))
    flags = nvcc_flags(new)
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            a = kernels(old, source, flags, Path(tmp))
            b = kernels(new, source, flags, Path(tmp))
            for name in sorted(set(a) | set(b)):
                if name not in a or name not in b:
                    verdict = "only in " + ("new" if name not in a else "old")
                elif a[name] == b[name]:
                    verdict = f"identical ({len(a[name])} instructions)"
                else:
                    verdict = f"differs ({len(a[name])} -> {len(b[name])} instructions)"
                print(f"{source}.cu {name}: {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
