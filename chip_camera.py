#!/usr/bin/env python3
"""Time the camera kernel (``csrc/rays.cu``: a block's packed starting rows) on one GPU, for comparing two trees in turns.

    python3 chip_camera.py --label NAME [--tree DIR]

On the 126,000-triangle torus at 1000×1000: the centre block of a 20-spp
pass (262,140 rows) and of an 8-spp pass (262,144 rows), pass seed 80,
``camera_rows`` held bit-equal to ``plain_camera_rows`` (a mismatch exits
non-zero) and timed as ``chip_smoke.py`` phase 6c times it (``_cuda_ms``:
CUDA events around 20 launches queued behind a device sleep), beside its
byte bound (64 bytes written a row at 3.35 TB/s). Prints the card's name
and power limit, then one JSON line.

``--tree DIR`` imports ``cuda_raytracer_tpu_torch`` from DIR (default: this
file's directory), so two versions of the kernel can be timed in turns (A,
B, B, A), each in its own process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--label", required=True)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("chip_camera: no CUDA device", file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
    from cuda_raytracer_tpu_torch.ops.kernels import rays

    smi = chip_smoke._smi()
    print(smi, flush=True)
    torus = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene("torus"),
                                     device=torch.device("cuda"))
    words = rays.camera_words(torus.camera)
    width, seed = torus.config.width, 80
    result = dict(label=args.label, card=smi)
    for rpp in (20, 8):
        lo, n = chip_smoke._centre_block(torus, rpp)
        got = rays.camera_rows(words, lo, n, rpp, width, seed)
        bad, _ = chip_smoke._bit_mismatch(
            (got,), (rays.plain_camera_rows(words, lo, n, rpp, width, seed),))
        if bad:
            raise SystemExit(f"chip_camera: {bad} mismatched words at {rpp} rays a pixel")
        ms = chip_smoke._cuda_ms(lambda: rays.camera_rows(words, lo, n, rpp, width, seed))
        bound_ms = (n * 64 + rays.CAMERA_WORDS * 4) / chip_smoke.PEAK_BYTES * 1e3
        result[f"rpp{rpp}"] = dict(rows=n, ms=ms, bound_ms=bound_ms, bound_share=bound_ms / ms)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
