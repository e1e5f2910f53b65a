#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (cuda_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, a forward render of a brute scene at the
reference benchmark shape (1000×1000, 100 rays per pixel in five passes of
20, 10 bounces), through the shade kernel, and checks it. Phases, one line
each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile ``csrc/shade.cu`` with nvcc, print seconds and registers;
3. kernel vs plain: each built-in scene at 64×64, 4 rays per pixel and 10
   bounces, plus an unaligned block (ray ids 100..359): per-ray agreement
   with the plain PyTorch version (max |Δ| < 1e-3 on ≥ 99.9 % of rays, none
   non-finite);
4. main path: ``render_timed`` of the Cornell- and spheres-style scenes,
   each after one untimed warm-up render; the kernel must launch exactly 5
   times per timed render, the framebuffer must be finite and the mean
   display value sane;
5. timing: one 20 M-ray Cornell pass — the kernel (median of 5, CUDA
   events), the plain version over the same pass in 2^18-ray blocks and at
   one 2^18 block, the live ray-bounces it holds, the FP32 bound they imply,
   and the kernel held against the plain version at that full shape; then
   the kernel alone on a cornell_plus and a spheres pass.

Then one JSON line per the kernel table, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Without a
CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

AGREE_TOL = 1e-3  # per-ray max |Δ| counted as agreeing
AGREE_MIN = 0.999  # fraction of rays that must agree
FULL = dict(width=1000, height=1000, rays_per_pixel=100, bounces=10)
SMALL = dict(width=64, height=64)
SMALL_RPP = 4
SMALL_BOUNCES = 10

# H100 SXM published peaks (dense, at the 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# FP32 arithmetic per unit of work, counted from csrc/shade.cu (each add,
# sub, mul, div, sqrt, max, sin, cos and int→float convert is one
# operation; compares and selects are not counted):
#   sphere test   3 sub, mhb 3 mul + 2 add, qc 4 mul + 3 add/sub,
#                 qd 1 mul + 1 sub, max, sqrt, near/far 2           = 21
#   triangle test h 6 mul + 3 sub, det 3 mul + 2 add, 1 div,
#                 f 3 sub, u 4 mul + 2 add, q 9, v 6, t 6, u+v 1    = 46
#   shading (per live bounce that hits): 5 converts + 5 scales,
#                 two on-sphere points 2×8, hit point 6, normal 3,
#                 facing 5, rough normal 16, cos 5, emission 6,
#                 ior/Schlick 15, scatter direction ~13, tint 3     = 98
#   camera ray (once per ray): 2 converts, 2 scales, 2 add, 2 mul,
#                 direction 12, normalise 9                         = 29
SPHERE_OPS = 21
TRI_OPS = 46
SHADE_OPS = 98
CAMERA_OPS = 29


def _smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _agreement(a, b):
    """(fraction of rays with max |Δ| < AGREE_TOL, worst |Δ|, all finite)."""
    import torch

    diff = (a - b).abs().amax(dim=1)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    return float((diff < AGREE_TOL).float().mean()), float(diff.max()), finite


def _cuda_ms(fn, runs: int):
    """Median milliseconds of ``fn()`` over ``runs`` runs, timed with CUDA
    events after one warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _scene(name: str, overrides: dict, device):
    from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl

    parsed = scene_dsl.parse_scene_text(builtin_scenes.SCENES[name], filename=name)
    return scene_dsl.assemble_scene(parsed, config_overrides=overrides, device=device)


def phase_kernel_vs_plain(device) -> None:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import shade

    for name in ("cornell", "cornell_plus", "spheres"):
        scene = _scene(name, SMALL, device)
        rays = SMALL["width"] * SMALL["height"] * SMALL_RPP
        for lo, n in ((0, rays), (100, 260)):
            ray_id = lo + torch.arange(n, dtype=torch.int32, device=device)
            got = shade.shade_trace(scene, ray_id, SMALL_RPP, 3, SMALL_BOUNCES)
            ref = shade.plain_trace(scene, ray_id, SMALL_RPP, 3, SMALL_BOUNCES)
            torch.cuda.synchronize()
            agree, worst, finite = _agreement(got, ref)
            print(f"phase 3 kernel vs plain: {name} block_lo={lo} rays={n} "
                  f"agree={agree:.6f} max_abs_err={worst:.3g} finite={finite}")
            if not finite or agree < AGREE_MIN:
                raise SystemExit(f"phase 3 failed: {name} block_lo={lo}")


def phase_main_path(device) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import shade
    from cuda_raytracer_tpu_torch.render import pipeline

    results = {"launches": 0}
    for name in ("cornell", "spheres"):
        scene = _scene(name, FULL, device)
        # Warm-up render (allocator blocks, clocks), outside the timed run;
        # its framebuffer is checked below.
        framebuffer = pipeline.render_framebuffer(scene)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        shade.LAUNCHES = 0
        image, seconds = pipeline.render_timed(scene)
        launches = shade.LAUNCHES
        results["launches"] += launches
        peak = torch.cuda.max_memory_allocated(device)
        finite = bool(torch.isfinite(framebuffer).all())
        mean = float(image.mean())
        same = bool((pipeline.render_image(scene, framebuffer=framebuffer) == image).all())
        rays = scene.num_pixels * scene.config.rays_per_pixel
        print(f"phase 4 main path: {name} {scene.config.width}x{scene.config.height} "
              f"spp={scene.config.rays_per_pixel} bounces={scene.config.bounces} "
              f"seconds={seconds:.4f} Mrays/s={rays / seconds / 1e6:.1f} "
              f"launches={launches} peak_mem_MiB={peak / 2**20:.1f} "
              f"finite={finite} mean_display={mean:.2f} rerender_identical={same}")
        if launches != 5 or not finite or not 20.0 <= mean <= 235.0:
            raise SystemExit(f"phase 4 failed: {name}")
    return results


def phase_timing(device) -> dict:
    import torch
    from cuda_raytracer_tpu_torch.ops.kernels import shade
    from cuda_raytracer_tpu_torch.render import pipeline, wavefront

    scene = _scene("cornell", FULL, device)
    rpp, bounces, seed = 20, scene.config.bounces, 80
    rays = scene.num_pixels * rpp
    block = pipeline.RAY_BLOCK
    ray_id = torch.arange(rays, dtype=torch.int32, device=device)

    kernel_ms = _cuda_ms(lambda: shade.shade_trace(scene, ray_id, rpp, seed, bounces), 5)
    got = shade.shade_trace(scene, ray_id, rpp, seed, bounces)

    block_ms = _cuda_ms(
        lambda: shade.plain_trace(scene, ray_id[:block], rpp, seed, bounces), 3
    )

    def plain_pass():
        return [shade.plain_trace(scene, ray_id[lo:lo + block], rpp, seed, bounces)
                for lo in range(0, rays, block)]

    plain_ms = _cuda_ms(plain_pass, 1)

    # The same pass once more, bounce by bounce, counting the live rays that
    # enter each bounce: the work the kernel actually has to do.
    live = torch.zeros((), dtype=torch.int64, device=device)
    ref = torch.empty_like(got)
    for lo in range(0, rays, block):
        state = wavefront.make_initial_state(scene, ray_id[lo:lo + block], rpp, seed)
        for b in range(bounces):
            live += torch.any(state.transmitted != 0.0, dim=-1).sum()
            state, _ = wavefront.process_rays(scene, state, seed, b)
        ref[lo:lo + block] = state.collected
    live = int(live)
    agree, worst, finite = _agreement(got, ref)

    per_bounce = SPHERE_OPS * scene.sphere_count + TRI_OPS * scene.triangle_count + SHADE_OPS
    ops = rays * CAMERA_OPS + live * per_bounce
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = rays * (4 + 12) / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"phase 5 timing: cornell pass rays={rays} kernel_ms={kernel_ms:.3f} "
          f"plain_pass_ms={plain_ms:.1f} plain_block_ms={block_ms:.3f} (rays={block}) "
          f"live_ray_bounces_per_ray={live / rays:.4f} ops_per_live_bounce={per_bounce} "
          f"fp32_bound_ms={ops_ms:.3f} bytes_bound_ms={bytes_ms:.4f} "
          f"bound_share={bound_ms / kernel_ms:.3f} full_shape_agree={agree:.6f} "
          f"max_abs_err={worst:.3g} finite={finite}")
    if not finite or agree < AGREE_MIN:
        raise SystemExit("phase 5 failed: kernel disagrees with plain at full shape")
    for name in ("cornell_plus", "spheres"):
        other = _scene(name, FULL, device)
        ms = _cuda_ms(lambda: shade.shade_trace(other, ray_id, rpp, seed, bounces), 5)
        print(f"phase 5 timing: {name} pass rays={rays} kernel_ms={ms:.3f}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                max_abs_err=worst, agreement=agree)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from cuda_raytracer_tpu_torch.ops.kernels import shade

    device = torch.device("cuda")
    smi = _smi()
    print(smi)
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    start = time.perf_counter()
    built = shade.library()
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    print(f"phase 2 build: shade.cu seconds={time.perf_counter() - start:.2f} "
          f"nvcc_seconds={built.seconds:.2f} {' | '.join(regs)}")

    phase_kernel_vs_plain(device)
    main_path = phase_main_path(device)
    timing = phase_timing(device)

    print(json.dumps({"kernels": [{
        "name": "shade_trace",
        "route": "cuda",
        "source": "cuda_raytracer_tpu_torch/csrc/shade.cu",
        "replaces": "cuda_raytracer_tpu/ops/pallas/shade.py:94",
        "launches": main_path["launches"],
        "max_abs_err": timing["max_abs_err"],
        "agreement": timing["agreement"],
        "tolerance": f"max |d| < {AGREE_TOL} on >= {AGREE_MIN} of rays",
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
