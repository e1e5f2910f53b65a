#!/usr/bin/env python3
"""Time one checkout of the PyTorch / CUDA port on one GPU, for comparing two trees in turns.

    python3 chip_turns.py --tree DIR --label NAME

imports ``cuda_raytracer_tpu_torch`` from ``DIR`` (default: this file's
directory) and prints one JSON line with NAME, the card and its power limit:

- ``cornell_s``: a 1000×1000, 100-spp, 10-bounce Cornell render (five
  20-spp passes through the brute-scene megakernel), after one untimed
  render; host clock around work ending in ``torch.cuda.synchronize``;
- ``torus_s``, ``torus_fb_sha256``: the 126,000-triangle torus at 1000×1000,
  100 spp, 10 bounces (the mesh main path, packet backend "auto"), after a
  128×128 warm-up, and a hash of its framebuffer's bytes (two trees that
  trace the same bits print the same hash);
- ``cullhit_s``, ``cullhit_fb_sha256``, ``torus_again_s``: the same render
  with ``sort_key="cullhit"`` (the reorder keyed by each ray's first two
  slab-hit cluster ids), twice, then the default render once more, so the
  two keys run in turns (Morton, cullhit, cullhit, Morton); the hash of
  the cullhit framebuffer (any reorder renders the same bits, so it equals
  ``torus_fb_sha256``). A tree whose config has no ``sort_key`` skips them;
- ``fused1_s``, ``fused_s``, ``fused1_fb_sha256``, ``engines_fb_equal``:
  the same 100-spp render through packet backend "fused1" (the single
  cull + walk + sweep kernel) and then "fused" (cull + fused) by name,
  whatever "auto" resolves to in the tree; the hash of the fused1
  framebuffer, and whether both framebuffers equal the "auto" one;
- ``bvh_s``, ``bvh_fb_sha256``: the same render through
  ``intersector="bvh"`` (the walk kernel), after a 128×128 warm-up, and
  the hash of its framebuffer (skipped on a tree without ``intersector``);
- ``block_wall_ms``, ``block_busy_ms``, ``block_idle_share``,
  ``block_kernels``: the torus's centre 2^18-ray block of a 20-spp pass
  (10 bounces, packet backend "auto") under torch.profiler: wall time,
  device busy time, the device's idle share and the device kernels it ran;
- ``block_walls_ms``: that block's wall time without the profiler, host
  clock around the call and a synchronise, 21 times after one untimed call,
  and their median ``block_wall_median_ms``;
- ``bvh_block_*``: the centre block as ``block_*`` is profiled and timed,
  through ``intersector="bvh"`` (skipped on a tree without it);
- ``train_s``: the median of 5 inverse-rendering train steps ("auto"
  engine, per-bounce checkpointing, Adam) on the 126,000-triangle torus at
  256×256 × 2 spp × 10 bounces, after 2 untimed steps: phase 10c's shape;
- ``train_busy_ms``, ``train_wall_ms``, ``train_kernels``: one more step
  under torch.profiler (after one more untimed step), the device's busy
  time (device-side events only), the wall time and the device kernels;
- ``pallas_*``: the same step through packet backend "pallas" (cull, pair
  extraction and the pair sweep kernel), its ``packet_cap`` doubled from
  the config's until the audit of one pass finds no suspect ray
  (``pallas_cap``): ``pallas_s`` (median of 5), ``pallas_busy_ms``,
  ``pallas_wall_ms``, ``pallas_idle_share``, ``pallas_kernels``;
- ``gated_block_*``: the centre block as ``block_*`` is profiled, through
  cull + fused with the hierarchical cull (``cull_hier=16``): wall, busy,
  idle share and device kernels;
- ``cullhit_block_*``: the centre block as ``block_*`` is profiled, with
  ``sort_key="cullhit"`` (skipped as ``cullhit_s`` is). The device kernels
  count every device operation the profiler sees, memsets included.

Only APIs that every tree since the train step (``render/diff.py``) has are
used, so an older tree unpacked with ``git archive`` runs it as it is. Run
the two trees alternately in one call (A, B, B, A), each in its own
process, so both see one card and one host.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TRAIN = dict(width=256, height=256, rays_per_pixel=2, bounces=10)
SEED = 7
STEPS = 5


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    parser.add_argument("--label", required=True)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device", file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
    from cuda_raytracer_tpu_torch.models.scene import precompute_camera
    from cuda_raytracer_tpu_torch.render import diff, pipeline

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]

    cornell = scene_dsl.assemble_scene(
        scene_dsl.parse_scene_text(builtin_scenes.CORNELL, filename="cornell"),
        config_overrides=dict(width=1000, height=1000, rays_per_pixel=100, bounces=10),
        device=device)
    pipeline.render_framebuffer(cornell)
    torch.cuda.synchronize()
    start = time.perf_counter()
    pipeline.render_framebuffer(cornell)
    torch.cuda.synchronize()
    cornell_s = time.perf_counter() - start

    full = scene_dsl.assemble_scene(builtin_scenes.parse_mesh_scene("torus"), device=device)
    cam = full.camera
    small = full.replace(camera=precompute_camera(
        cam.position.cpu().numpy(), cam.forward.cpu().numpy(), cam.up.cpu().numpy(),
        cam.vertical_fov, 128, 128, device=device)).with_config(width=128, height=128)
    pipeline.render_framebuffer(small.with_config(rays_per_pixel=20))
    torch.cuda.synchronize()
    start = time.perf_counter()
    torus_fb = pipeline.render_framebuffer(full.with_config(rays_per_pixel=100))
    torch.cuda.synchronize()
    torus_s = time.perf_counter() - start
    torus_sha = hashlib.sha256(torus_fb.cpu().numpy().tobytes()).hexdigest()

    def timed_render(scene):
        """(seconds, framebuffer) of one render ending in a synchronise."""
        torch.cuda.synchronize()
        start = time.perf_counter()
        fb = pipeline.render_framebuffer(scene)
        torch.cuda.synchronize()
        return time.perf_counter() - start, fb

    cullhit = {}
    if "sort_key" in {f.name for f in dataclasses.fields(full.config)}:
        keyed = full.with_config(rays_per_pixel=100, sort_key="cullhit")
        turns = [timed_render(keyed) for _ in range(2)]
        again_s, again_fb = timed_render(full.with_config(rays_per_pixel=100))
        cullhit = dict(cullhit_s=[s for s, _ in turns], torus_again_s=again_s,
                       cullhit_fb_sha256=hashlib.sha256(
                           turns[0][1].cpu().numpy().tobytes()).hexdigest(),
                       cullhit_fb_equal=all(torch.equal(fb, torus_fb) for _, fb in turns)
                       and torch.equal(again_fb, torus_fb))

    fused1_s, fused1_fb = timed_render(full.with_config(rays_per_pixel=100,
                                                        packet_backend="fused1"))
    fused_s, fused_fb = timed_render(full.with_config(rays_per_pixel=100,
                                                      packet_backend="fused"))
    engines = dict(fused1_s=fused1_s, fused_s=fused_s,
                   fused1_fb_sha256=hashlib.sha256(fused1_fb.cpu().numpy().tobytes()).hexdigest(),
                   engines_fb_equal=torch.equal(fused1_fb, torus_fb)
                   and torch.equal(fused_fb, torus_fb))
    del fused1_fb, fused_fb
    if "intersector" in {f.name for f in dataclasses.fields(full.config)}:
        pipeline.render_framebuffer(small.with_config(rays_per_pixel=20, intersector="bvh"))
        bvh_s, bvh_fb = timed_render(full.with_config(rays_per_pixel=100, intersector="bvh"))
        engines.update(bvh_s=bvh_s, bvh_fb_sha256=hashlib.sha256(
            bvh_fb.cpu().numpy().tobytes()).hexdigest())
        del bvh_fb

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        """(wall ms, device busy ms, device kernels) of one call of fn."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
        busy, kernels = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU:
                busy += getattr(e, "self_device_time_total", 0.0) / 1e3
                kernels += e.count
        return wall, busy, kernels

    # The pass block that holds the image centre, rendered as render_pass
    # renders it (the tree's regime for "auto"): one block of whole pixels.
    rpp = 20
    block = (pipeline.RAY_BLOCK // rpp) * rpp
    centre = (full.config.height // 2 * full.config.width + full.config.width // 2) * rpp
    px_lo = centre // block * block // rpp
    framebuffer = torch.zeros((full.num_pixels, 3), device=device)
    block_wall, block_busy, block_kernels = profiled(lambda: pipeline.render_pass(
        full, framebuffer, 80, rpp, full.config.bounces, True,
        pixels=(px_lo, px_lo + block // rpp)))
    def walls(scene):
        """21 unprofiled wall times (ms) of the centre block, after one."""
        def call():
            pipeline.render_pass(scene, framebuffer, 80, rpp, scene.config.bounces, True,
                                 pixels=(px_lo, px_lo + block // rpp))
        call()
        out = []
        for _ in range(21):
            torch.cuda.synchronize()
            start = time.perf_counter()
            call()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - start) * 1e3)
        return out

    block_walls = walls(full)
    engines.update(block_walls_ms=block_walls,
                   block_wall_median_ms=statistics.median(block_walls))
    if "bvh_s" in engines:
        bvh_scene = full.with_config(intersector="bvh")
        wall, busy, kernels = profiled(lambda: pipeline.render_pass(
            bvh_scene, framebuffer, 80, rpp, bvh_scene.config.bounces, True,
            pixels=(px_lo, px_lo + block // rpp)))
        bvh_walls = walls(bvh_scene)
        engines.update(bvh_block_wall_ms=wall, bvh_block_busy_ms=busy,
                       bvh_block_idle_share=1 - busy / wall, bvh_block_kernels=kernels,
                       bvh_block_walls_ms=bvh_walls,
                       bvh_block_wall_median_ms=statistics.median(bvh_walls))
    gated = full.with_config(packet_backend="fused", cull_hier=16)
    gated_wall, gated_busy, gated_kernels = profiled(lambda: pipeline.render_pass(
        gated, framebuffer, 80, rpp, gated.config.bounces, True,
        pixels=(px_lo, px_lo + block // rpp)))
    if cullhit:
        keyed = full.with_config(sort_key="cullhit")
        wall, busy, kernels = profiled(lambda: pipeline.render_pass(
            keyed, framebuffer, 80, rpp, keyed.config.bounces, True,
            pixels=(px_lo, px_lo + block // rpp)))
        cullhit.update(cullhit_block_wall_ms=wall, cullhit_block_busy_ms=busy,
                       cullhit_block_idle_share=1 - busy / wall, cullhit_block_kernels=kernels)

    camera = precompute_camera(cam.position.cpu().numpy(), cam.forward.cpu().numpy(),
                               cam.up.cpu().numpy(), cam.vertical_fov, TRAIN["width"],
                               TRAIN["height"], device=device)
    scene = full.replace(camera=camera).with_config(**TRAIN)
    rpp, bounces = TRAIN["rays_per_pixel"], TRAIN["bounces"]
    true_params, _ = diff.split_params(scene)
    with torch.no_grad():
        target = diff.render_radiance(true_params, scene, SEED, rpp, bounces)
    start_params = diff.params_to_numpy(true_params)
    start_params["materials.diffuse_albedo"][:] = 0.5
    schedule = diff.calibrate_live_schedule(scene, seeds=(SEED, SEED + 1))

    def train(step_scene):
        """(median step seconds, the steps' seconds, profiled wall ms, busy ms,
        device kernels) of the checkpointed Adam step on ``step_scene``."""
        params = diff.params_from_numpy(start_params, device, requires_grad=True)
        optimizer = torch.optim.Adam(diff.param_leaves(params), lr=2e-2)
        step = diff.make_train_step(step_scene, optimizer, rpp, bounces,
                                    live_schedule=schedule, checkpoint_bounces=True)
        for _ in range(2):
            step(params, target, SEED)
        torch.cuda.synchronize()
        seconds = []
        for _ in range(STEPS):
            start = time.perf_counter()
            step(params, target, SEED)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
        return (statistics.median(seconds), seconds,
                *profiled(lambda: step(params, target, SEED)))

    train_s, steps_s, wall_ms, busy_ms, train_kernels = train(scene)
    cap = scene.config.packet_cap
    while diff.check_radiance_exact(scene.with_config(packet_backend="pallas", packet_cap=cap),
                                    pass_seed=SEED) and cap < scene.num_clusters:
        cap = min(2 * cap, scene.num_clusters)
    pallas_s, pallas_steps, p_wall, p_busy, p_kernels = train(
        scene.with_config(packet_backend="pallas", packet_cap=cap))
    print(json.dumps(dict(label=args.label, card=smi, cornell_s=cornell_s, torus_s=torus_s,
                          torus_fb_sha256=torus_sha, block_wall_ms=block_wall,
                          block_busy_ms=block_busy, block_idle_share=1 - block_busy / block_wall,
                          block_kernels=block_kernels, gated_block_wall_ms=gated_wall,
                          gated_block_busy_ms=gated_busy,
                          gated_block_idle_share=1 - gated_busy / gated_wall,
                          gated_block_kernels=gated_kernels,
                          train_s=train_s, train_steps_s=steps_s,
                          train_busy_ms=busy_ms, train_wall_ms=wall_ms,
                          train_kernels=train_kernels, pallas_cap=cap, pallas_s=pallas_s,
                          pallas_steps_s=pallas_steps, pallas_busy_ms=p_busy,
                          pallas_wall_ms=p_wall, pallas_idle_share=1 - p_busy / p_wall,
                          pallas_kernels=p_kernels, **engines, **cullhit)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
