#!/usr/bin/env python3
"""Time the BVH walk kernel (``csrc/traverse.cu``) bounce by bounce on one GPU.

    python3 chip_walk.py [--lanes 1,8,32] [--glass] [--lamp] [--profile] [--sweep]
    python3 chip_walk.py --tree DIR --times [--profile]

Traces the 126,000-triangle torus's centre 20-spp block (1000×1000, 10
bounces, ``intersector="bvh"``) as ``packed.trace_packed`` traces it and
runs ``chip_smoke.py``'s phase-13a check on each bounce 0-9, at the live
prefix the render hands the walk: the kernel at the rays a warp it picks
and at each of ``--lanes`` (default ``chip_smoke.WALK_LANES``), each
bit-equal to the plain lockstep walk (a mismatch exits non-zero), each
launch's device ms, the live count, the mean and largest pops a live ray.
A summary line per launch lists its ms a bounce and their sum.

``--glass`` adds the glass torus's bounces 0-3 and ``--lamp`` the desk
lamp's bounces 0-9 (the benchmark's ``desk_lamp`` configuration, 619,350
triangles of mixed scale: its set-up seconds, tree and walk tables first),
both at the same lanes;
``--profile`` adds the block under torch.profiler (the walk's device ms a
bounce, the block's busy and idle share); ``--sweep`` times the first n
rays of bounce 1 (n = 4,096 to all) at 1-32 rays a warp.

``--tree DIR`` imports ``cuda_raytracer_tpu_torch`` from DIR (default: this
file's directory); ``--times`` times each bounce at the kernel's own launch
only, bit-equal to the plain walk, through calls every tree since the
walk's port has, so an older tree unpacked with ``git archive`` can be
timed beside this one in turns (A, B, B, A), each in its own process.
Prints the card's name and power limit first; exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import chip_smoke

RPP, SEED = 20, 80


def lanes_sweep(scene, rows) -> None:
    """The walk on the first n ``rows`` (n from 4,096 to all of them) at
    1-32 rays a warp and the kernel's pick (0): where one ray a warp stops
    paying. Each launch bit-equal to the plain walk."""
    from cuda_raytracer_tpu_torch.ops import traverse
    from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel

    o, d, t0, i0, _ = chip_smoke._walk_inputs(scene, rows)
    for n in (4096, 16384, 65536, o.shape[0]):
        args = (o[:n], d[:n], t0[:n], i0[:n])
        want = traverse.plain_bvh_closest_hit(scene, *args)
        ms = {}
        for lanes in (0, 1, 2, 4, 8, 16, 32):
            bad, _ = chip_smoke._bit_mismatch(
                traverse_kernel.bvh_walk(scene, *args, lanes=lanes), want)
            if bad:
                raise SystemExit(f"chip_walk: the walk differs from its plain version "
                                 f"(n {n}, lanes {lanes})")
            ms[lanes] = chip_smoke._cuda_ms(
                lambda: traverse_kernel.bvh_walk(scene, *args, lanes=lanes))
        print(f"walk: lanes sweep n={n} ms_by_lanes(0=pick)="
              + json.dumps({k: round(v, 4) for k, v in ms.items()}))


def block_times(scene) -> None:
    """Each bounce of ``scene``'s centre block at the kernel's own launch:
    bit-equal to the plain walk, its device ms, and their sum."""
    import torch
    from cuda_raytracer_tpu_torch.ops import traverse
    from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel

    block_lo, block = chip_smoke._centre_block(scene, RPP)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    ms = []
    for b, rows in chip_smoke._traced_rows(scene, ids, RPP, SEED):
        o, d, t0, i0, _ = chip_smoke._walk_inputs(scene, rows)
        bad, _ = chip_smoke._bit_mismatch(traverse_kernel.bvh_walk(scene, o, d, t0, i0),
                                          traverse.plain_bvh_closest_hit(scene, o, d, t0, i0))
        if bad:
            raise SystemExit(f"chip_walk: the walk differs from its plain version (bounce {b})")
        ms.append(chip_smoke._cuda_ms(lambda: traverse_kernel.bvh_walk(scene, o, d, t0, i0)))
    print(f"walk: times ms_per_bounce={' '.join(f'{x:.4f}' for x in ms)} "
          f"sum_ms={sum(ms):.4f} tail_sum_ms={sum(ms[2:]):.4f}")


def block_walks(scene, name: str, bounces: int, lanes) -> None:
    """``_walk_check`` on ``scene``'s centre block at bounces [0, bounces),
    then a summary line per launch."""
    import torch

    block_lo, block = chip_smoke._centre_block(scene, RPP)
    ids = block_lo + torch.arange(block, dtype=torch.int32, device=scene.device)
    out = []
    for b, r in chip_smoke._traced_rows(scene, ids, RPP, SEED):
        if b >= bounces:
            break
        out.append(chip_smoke._walk_check(scene, r, f"{name} centre block lo={block_lo}", b,
                                          True, lanes=lanes))
    for launch in ["default"] + list(out[0]["lanes_ms"]):
        ms = [r["ms"] if launch == "default" else r["lanes_ms"][launch] for r in out]
        print(f"walk: summary {name} launch={launch} ms_per_bounce="
              f"{' '.join(f'{x:.4f}' for x in ms)} sum_ms={sum(ms):.4f} "
              f"tail_sum_ms={sum(ms[2:]):.4f}")


def lamp_scene(device):
    """The desk lamp as the benchmark's ``desk_lamp`` configuration holds it
    (scene text from ``rtbench/scenes/desk_lamp.py``, 1000×1000, 10
    bounces), walked through ``intersector="bvh"`` at RPP rays a pixel;
    prints its set-up seconds, its tree and its walk tables' size."""
    import numpy as np
    from cuda_raytracer_tpu_torch.models import scene_dsl
    from cuda_raytracer_tpu_torch.ops.kernels import traverse as traverse_kernel
    from rtbench.core.spec import load_module

    root = Path(__file__).resolve().parent
    cfg = json.loads((root / "rtbench" / "configs" / "desk_lamp.json").read_text())
    generator = load_module(root / "rtbench" / "scenes" / f"{cfg['scene']}.py")
    start = time.perf_counter()
    text, _ = generator.generate(cfg["scene_params"], np.random.default_rng(SEED))
    text += f"image {cfg['width']} {cfg['height']} {RPP} {cfg['bounces']} {cfg['exposure']}\n"
    made = time.perf_counter() - start
    scene = scene_dsl.assemble_scene(scene_dsl.parse_scene_text(text, filename="desk_lamp"),
                                     config_overrides=dict(cfg["render"], intersector="bvh"),
                                     device=device)
    loaded = time.perf_counter() - start - made
    tb = traverse_kernel.walk_tables(scene)
    mb = [x.numel() * x.element_size() / 1e6 for x in (tb.records, tb.triangles)]
    print(f"walk: desk_lamp triangles={scene.triangle_count} bvh_nodes={scene.bvh_node_count} "
          f"depth={traverse_kernel.tree_depth(scene.bvh_child1, scene.bvh_child2)} "
          f"max_leaf={scene.max_leaf_size} text_seconds={made:.1f} load_seconds={loaded:.1f} "
          f"records_MB={mb[0]:.2f} triangles_MB={mb[1]:.2f}")
    return scene


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--lanes", default=",".join(map(str, chip_smoke.WALK_LANES)))
    parser.add_argument("--glass", action="store_true")
    parser.add_argument("--lamp", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--times", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    lanes = tuple(int(k) for k in args.lanes.split(",") if k)
    if not torch.cuda.is_available():
        print("chip_walk: no CUDA device", file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.native import bvh_native
    from cuda_raytracer_tpu_torch.ops.kernels import build

    print(chip_smoke._smi())
    print(f"walk: tree {args.tree}")
    built = build.load_all(("rays", "bounce", "traverse"))
    for line in built["traverse"].log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"walk: build traverse.cu {line.strip()}")
    bvh_native.library()
    device = torch.device("cuda")
    torus = chip_smoke._mesh_scene("torus", device).with_config(
        rays_per_pixel=RPP, intersector="bvh")
    if args.times:
        block_times(torus)
    else:
        block_walks(torus, "torus", 10, lanes)
    if args.glass:
        glass = chip_smoke._mesh_scene("glass_torus", device).with_config(
            rays_per_pixel=RPP, intersector="bvh")
        block_walks(glass, "glass_torus", 4, lanes)
    if args.profile:
        chip_smoke._profile_block(torus, "bvh", ("bvh_walk_kernel",), "walk")
    if args.sweep:
        block_lo, block = chip_smoke._centre_block(torus, RPP)
        ids = block_lo + torch.arange(block, dtype=torch.int32, device=device)
        rows = [r.clone() for b, r in chip_smoke._traced_rows(torus, ids, RPP, SEED) if b < 2]
        lanes_sweep(torus, rows[1])
    if args.lamp:
        block_walks(lamp_scene(device), "desk_lamp", 10, lanes)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
