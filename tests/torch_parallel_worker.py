"""Ranks of the port's sharding tests: CPU processes joined by gloo.

``spawn(jobs, size, timeout)`` starts ``size`` processes with
``torch.multiprocessing`` ("spawn"); each joins one gloo group on the CPU,
runs every job of ``jobs`` (names of the functions below, with their
keyword arguments) on the group's mesh, and saves what the jobs return.
The parent gets one list of results per rank. This module imports no JAX,
so the ranks start quickly; the tests compare the results with JAX.
"""

from __future__ import annotations

import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.parallel import mesh as mesh_mod
from cuda_raytracer_tpu_torch.parallel import shard
from cuda_raytracer_tpu_torch.render import diff

CORNELL = dict(width=8, height=8, rays_per_pixel=4, bounces=3)
ODD = dict(width=9, height=9, rays_per_pixel=1, bounces=2)  # 81 rays: no even split
TORUS = dict(width=16, height=16, rays_per_pixel=2, bounces=3)


def build_scene(name: str, overrides: dict, cluster_tris: int = 64):
    """A built-in scene on the CPU: ``"cornell"``, or the small torus
    (``"torus"``; ``"torus_packed"`` with ``cluster_pack=2``)."""
    if name == "cornell":
        parsed = scene_dsl.parse_scene_text(builtin_scenes.CORNELL)
        return scene_dsl.assemble_scene(parsed, config_overrides=overrides,
                                        prefer_native_bvh=False, device="cpu")
    parsed = builtin_scenes.parse_mesh_scene("torus", builtin_scenes.SMALL)
    if name == "torus_packed":
        overrides = dict(overrides, cluster_pack=2)
    return scene_dsl.assemble_scene(parsed, config_overrides=overrides,
                                    prefer_native_bvh=False, cluster_tris=cluster_tris,
                                    device="cpu")


def target_for(scene, seed: int = 3, rpp: int = 2, bounces: int = 3) -> np.ndarray:
    """The tests' radiance target: the scene's own render at another seed."""
    with torch.no_grad():
        params = diff.split_params(scene)[0]
        return diff.render_radiance(params, scene, seed, rpp, bounces).numpy()


def render(mesh, scene: str, overrides: dict):
    fb = shard.render_framebuffer_sharded(build_scene(scene, overrides), mesh)
    return fb.numpy()


def grads(mesh, scene: str, overrides: dict, target: np.ndarray, seed: int, rpp: int,
          bounces: int):
    loss, g = shard.sharded_loss_and_grad(build_scene(scene, overrides), mesh,
                                          torch.from_numpy(target), seed, rpp, bounces)
    return float(loss), diff.params_to_numpy(g)


def train(mesh, scene: str, overrides: dict, target: np.ndarray, steps: int, lr: float):
    """``steps`` Adam steps from halved diffuse albedos → (losses,
    parameters after the last step)."""
    s = build_scene(scene, overrides)
    start = diff.params_to_numpy(diff.split_params(s)[0])
    start["materials.diffuse_albedo"] *= 0.5
    params = diff.params_from_numpy(start, "cpu", requires_grad=True)
    optimizer = torch.optim.Adam(diff.param_leaves(params), lr=lr)
    step = shard.make_sharded_train_step(s, mesh, optimizer, rays_per_pixel=2, bounces=3)
    target = torch.from_numpy(target)
    losses = [float(step(params, target, 3)) for _ in range(steps)]
    return losses, diff.params_to_numpy(params)


def scaling(mesh, scene: str, overrides: dict):
    return shard.scaling_report(build_scene(scene, overrides), mesh, rays_per_pixel=2,
                                repeats=1)


def _rank(rank: int, size: int, coordinator: str, jobs, out_dir: str) -> None:
    torch.set_num_threads(1)  # the ranks share this machine's cores
    mesh = mesh_mod.init_group(coordinator, size, rank, "cpu")
    try:
        results = [globals()[name](mesh, **kwargs) for name, kwargs in jobs]
    finally:
        mesh_mod.shutdown()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")


def spawn(jobs, size: int, out_dir, timeout: float = 120.0):
    """Run ``jobs`` on ``size`` gloo ranks → [results of rank 0, ...]. A
    rank that fails raises here; ranks still running after ``timeout``
    seconds are killed and raise TimeoutError."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        coordinator = f"localhost:{s.getsockname()[1]}"
    ctx = mp.start_processes(_rank, args=(size, coordinator, jobs, str(out_dir)),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{size} ranks still running after {timeout} s")
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(size)]
