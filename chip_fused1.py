#!/usr/bin/env python3
"""Time the fused1 kernel (``csrc/fused1.cu``) bounce by bounce on one GPU, at several splits, for comparing two trees in turns.

    python3 chip_fused1.py --label NAME [--tree DIR] [--pack 1|2] [--units 16,32]

Traces the 126,000-triangle torus's centre 2^18-ray block of a 20-spp pass
(1000×1000, 10 bounces) as a render traces it (``chip_smoke._traced_od8``:
the live prefix, the Morton sort) and, on the ray tiles entering each bounce
0-9, times the kernel (``chip_smoke._cuda_ms``) at one block per tile, and
for each split unit in ``--units`` (boxes a chunk of the split kernel:
``fused1.SPLIT_CHUNK``, set for the calls) at ``split_plan``'s choice, at
one split a chunk and at a half and a quarter of that; every launch is held
bit-equal to ``plain_fused1`` first (a mismatch exits non-zero). ``--pack
2`` runs the paired sub-cluster table (``cluster_pack=2``,
``chip_smoke._packed_scenes``). Prints the card's name and power limit, the
kernels' registers as ptxas reports them, one line a bounce, and one JSON
line last.

``--tree DIR`` imports ``cuda_raytracer_tpu_torch`` from DIR (default: this
file's directory), so an older tree unpacked with ``git archive`` (or a
variant of this one) can be timed beside this one in turns (A, B, B, A),
each in its own process. Only calls every tree since fused1's split grid
has are used.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke

GATE = 16  # boxes a super box, as the engine's default cull_hier


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--label", required=True)
    parser.add_argument("--pack", type=int, default=1, choices=(1, 2))
    parser.add_argument("--units", default="16,32")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("chip_fused1: no CUDA device", file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.ops import packet_intersect
    from cuda_raytracer_tpu_torch.ops.kernels import build, fused1

    smi = chip_smoke._smi()
    print(smi, flush=True)
    built = build.load("fused1")
    print("registers: " + " | ".join(
        ln.strip() for ln in built.log.splitlines() if "registers" in ln), flush=True)
    device = torch.device("cuda")
    pack = args.pack
    scene = (chip_smoke._mesh_scene("torus", device) if pack == 1
             else chip_smoke._packed_scenes(device)[0])
    rpp, seed = 20, 80
    scene = scene.with_config(rays_per_pixel=rpp)
    block_lo, block = chip_smoke._centre_block(scene, rpp)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    K = scene.num_clusters
    aabb = packet_intersect.box_table(scene)
    sup = packet_intersect.super_table(scene, GATE)
    blocks = scene.cluster_blocks[:K // pack].contiguous()
    own_unit = fused1.SPLIT_CHUNK
    rows = []
    for b, n, od8 in chip_smoke._traced_od8(scene, ids, rpp, seed):
        T = od8.shape[0]
        ref = fused1.plain_fused1(od8, aabb, blocks, pack=pack)
        cases = [(own_unit, 1)]  # one block per tile: 128-box chunks, whatever the unit
        for unit in (int(u) for u in args.units.split(",")):
            fused1.SPLIT_CHUNK = unit
            chunks = -(-K // max(unit, GATE))
            cases += [(unit, s) for s in sorted(
                {fused1.split_plan(T, K, GATE)[0], chunks, max(2, chunks // 2),
                 max(2, chunks // 4)} - {1})]
        times = {}
        for unit, splits in cases:
            fused1.SPLIT_CHUNK = unit

            def run(splits=splits):
                return fused1.fused1_closest_hit(od8, aabb, blocks, sup, GATE, pack=pack,
                                                 splits=splits)

            if chip_smoke._mismatch(run(), ref)[0]:
                raise SystemExit(f"chip_fused1: bounce {b}, unit {unit}, {splits} splits "
                                 f"differs from plain_fused1")
            times["1" if splits == 1 else f"{unit}x{splits}"] = chip_smoke._cuda_ms(run)
        fused1.SPLIT_CHUNK = own_unit
        row = dict(bounce=b, rays=n, tiles=T,
                   live_tiles=int((od8[:, 6, :] >= 0).any(dim=1).sum()),
                   chosen=fused1.split_plan(T, K, GATE)[0], ms=times)
        print(f"{args.label} fused1 pack={pack} " + json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps(dict(label=args.label, card=smi, pack=pack, bounces=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
