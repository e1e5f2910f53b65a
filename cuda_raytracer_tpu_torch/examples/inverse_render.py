"""Inverse rendering demo: recover wall colours from a target image (counterpart of ``examples/inverse_render.py``).

The whole wavefront is differentiable, so a scalar loss on rendered
radiance yields gradients for every material channel, and Adam recovers
scene parameters from pixels. This renders the built-in Cornell box
(``models/builtin_scenes.CORNELL``) as the target, greys out every coloured
diffuse surface (emitters keep their albedo), then optimises all the scene's
parameters until the render matches the target: the red and green walls
come back.

    python -m cuda_raytracer_tpu_torch.examples.inverse_render [--size 64]
        [--spp 8] [--steps 60] [--bounces 4] [--out DIR] [--cpu]

It runs on the GPU unless ``--cpu`` is given, prints the loss curve and the
true against the recovered wall albedos, writes target.png, initial.png and
recovered.png to ``--out`` when one is given, and exits 0 when the mean
absolute error on the coloured walls is below 0.15.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.tonemap import to_bytes, tonemap
from cuda_raytracer_tpu_torch.render import diff
from cuda_raytracer_tpu_torch.utils.backend import resolve_device
from cuda_raytracer_tpu_torch.utils.png import write_png

ERROR_BAR = 0.15  # mean |error| on the coloured walls for a pass


def run(size: int = 64, spp: int = 8, steps: int = 60, bounces: int = 4, lr: float = 5e-2,
        device=None, out: str = None, log=print) -> dict:
    """The recovery → {"losses", "err", "true_albedo", "recovered_albedo"}."""
    device = resolve_device(device)
    parsed = scene_dsl.parse_scene_text(builtin_scenes.CORNELL, filename="cornell")
    scene = scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=size, height=size, rays_per_pixel=spp,
                                      bounces=bounces), device=device)
    true_params, _ = diff.split_params(scene)

    # The target is rendered with the SAME seed the optimiser uses, so the
    # true parameters are an exact zero-loss optimum even at low spp.
    with torch.no_grad():
        target = diff.render_radiance(true_params, scene, 0, spp, bounces)

    true_mats = true_params.materials
    is_emitter = (true_mats.emitted.amax(dim=1) > 0)[:, None]
    grey = torch.where(is_emitter, true_mats.diffuse_albedo, 0.5)
    params = diff.make_leaves(true_params._replace(
        materials=dataclasses.replace(true_mats, diffuse_albedo=grey)))

    def to_png(radiance, name):
        if out is not None:
            display = tonemap(radiance.detach().reshape(size, size, 3), scene.config.exposure, 1)
            write_png(os.path.join(out, name), to_bytes(display).cpu().numpy())

    if out is not None:
        os.makedirs(out, exist_ok=True)
    to_png(target, "target.png")
    with torch.no_grad():
        to_png(diff.render_radiance(params, scene, 0, spp, bounces), "initial.png")

    optimizer = torch.optim.Adam(diff.param_leaves(params), lr=lr)
    step = diff.make_train_step(scene, optimizer, rays_per_pixel=spp, bounces=bounces)
    losses = []
    for i in range(steps):
        losses.append(float(step(params, target, 0)))
        with torch.no_grad():  # keep albedos physical between steps
            params.materials.diffuse_albedo.clamp_(0.0, 1.0)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.6f}")

    with torch.no_grad():
        to_png(diff.render_radiance(params, scene, 0, spp, bounces), "recovered.png")
    true_alb = true_mats.diffuse_albedo.cpu().numpy()
    got_alb = np.clip(params.materials.diffuse_albedo.detach().cpu().numpy(), 0.0, 1.0)
    sat = true_alb.max(axis=1) - true_alb.min(axis=1)
    log("\nmaterial  true albedo          recovered")
    for m in np.argsort(-sat)[:3]:
        log(f"{m:8d}  {np.array2string(true_alb[m], precision=2)}"
            f"  {np.array2string(got_alb[m], precision=2)}")
    err = float(np.abs(true_alb[sat > 0.2] - got_alb[sat > 0.2]).mean())
    log(f"\nmean |error| on coloured walls: {err:.3f}")
    return dict(losses=losses, err=err, true_albedo=true_alb, recovered_albedo=got_alb)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--bounces", type=int, default=4)
    parser.add_argument("--out", default=None, help="directory for the three PNGs")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    result = run(args.size, args.spp, args.steps, args.bounces,
                 device="cpu" if args.cpu else None, out=args.out)
    return 0 if result["err"] < ERROR_BAR else 1


if __name__ == "__main__":
    raise SystemExit(main())
