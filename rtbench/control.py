"""The comparison's control and planted faults, read at a cell's own size.

    python3 rtbench/control.py --workload <cell> --seeds 11,12,13

For each seed it prints one JSON line with the numbers ``run.py``
compares, read from the control in the program's place: the plain
reference computed in bfloat16, the next precision below the float32 the
configurations state, held against the float32 reference. An image cell
reads ``fb_rel_l1`` at the cell's sampled pixels and ``post_bytes_off``
from the post-pass in bfloat16 on the program's own framebuffer of that
seed; the train cell reads ``loss_gap``, ``grad_gap`` and ``change_gap``
of the first steps, and beside the control two faults planted in the
reference: half of the pixels left out of the loss, the mean taken over
the rest (``half_batch``), and the diffuse albedo's gradient altered by
10 % where it is produced (``grad_altered``). The smallest of these
readings are the limits' upper readings (PERF.md). ``run.py`` never runs
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench.core import cells, spec  # noqa: E402
from rtbench.reference import dsl as ref_dsl  # noqa: E402
from rtbench.reference import post as ref_post  # noqa: E402
from rtbench.reference import tracer as ref_tracer  # noqa: E402
from rtbench.reference import train as ref_train  # noqa: E402

LOWER = torch.bfloat16


def image_control(cell: spec.Cell, seed: int, device) -> dict:
    from cuda_raytracer_tpu_torch.render import pipeline

    cfg = cell.config
    W, H, spp = cfg["width"], cfg["height"], cell.traffic["rays_per_pixel"]
    per_pass = cfg["render"].get("max_rays_per_pixel_per_pass", 20)
    rng_scene, rng_check, _, _ = cells.seed_streams(seed)
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmpdir:
        tmp = Path(tmpdir)
        text = cells.scene_text(cell, rng_scene, W, H, spp, tmp)
        _, scene, _ = cells.load_program_scene(cell, text, tmp, device)
        fb = pipeline.render_framebuffer(scene)
        del scene
        ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
    index = cells.check_pixels(cell, rng_check, W, H, device)
    env = torch.from_numpy(ref_scene.environment_map).to(device)
    mats = ref_tracer.material_tensors(ref_scene, device)
    sums = {}
    with torch.no_grad():
        for dtype in (torch.float32, LOWER):
            geo = ref_tracer.geometry(ref_scene, device, dtype)
            sums[dtype] = ref_tracer.pixel_sums(geo, mats, env, index, spp, cfg["bounces"],
                                                per_pass)
        exact = ref_post.image_bytes(fb, W, H, spp, cfg["exposure"])
        lower = ref_post.image_bytes(fb, W, H, spp, cfg["exposure"], LOWER)
    ref = sums[torch.float32]
    return {"fb_rel_l1": float((sums[LOWER] - ref).abs().sum() / ref.abs().sum()),
            "post_bytes_off": float(np.mean(exact != lower))}


def train_control(cell: spec.Cell, seed: int, device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    W, H, spp = traffic["width"], traffic["height"], traffic["rays_per_pixel"]
    rng_scene, start_albedo, target_seed, base = cells.train_inputs(cell, seed)
    steps = [base + k for k in range(traffic["checked_steps"])]
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmpdir:
        tmp = Path(tmpdir)
        text = cells.scene_text(cell, rng_scene, W, H, spp, tmp)
        ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
    true_leaves, start_leaves = cells.reference_leaves(cell, ref_scene, start_albedo, device)

    def follow(dtype=torch.float32, fault=None) -> dict:
        geo = ref_tracer.geometry(ref_scene, device, dtype)
        out = ref_train.follow(geo, true_leaves, start_leaves, W * H, spp, cfg["bounces"],
                               target_seed, steps, traffic["learning_rate"], fault=fault)
        return dict(losses=out["losses"],
                    first_grad=[out["first_grad"][k] for k in ref_train.LEAVES],
                    change=[out["change"][k] for k in ref_train.LEAVES])

    def half_batch(name, value):
        return value[: value.shape[0] // 2] if name == "pixels" else value

    def grad_altered(name, value):
        if name == "grads":
            value = dict(value, diffuse=value["diffuse"] * 1.1)
        return value

    ref = ref_train.follow(ref_tracer.geometry(ref_scene, device), true_leaves, start_leaves,
                           W * H, spp, cfg["bounces"], target_seed, steps,
                           traffic["learning_rate"])
    return {name: cells.train_numbers(follow(*args), ref)
            for name, args in (("control", (LOWER,)), ("half_batch", (torch.float32, half_batch)),
                               ("grad_altered", (torch.float32, grad_altered)))}


def main(argv=None, root: Path = ROOT, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    cell = spec.load_cell(Path(root), args.workload)
    device = torch.device(device or "cuda")
    read = {"image": image_control, "train": train_control}[cell.kind]
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        numbers = read(cell, seed, device)
        print(json.dumps(dict(workload=cell.name, seed=seed, numbers=numbers,
                              seconds=time.perf_counter() - start)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
