"""Ray-parallel rendering and training over a process group (counterpart of ``cuda_raytracer_tpu/parallel/shard.py``).

The decomposition is the JAX package's: the scene is replicated in every
rank, each rank traces a contiguous share of a pass's rays into a full-size
local framebuffer, and the framebuffers and suspect counts are summed over
the group (``Mesh.all_reduce``). Shares are cut at whole pixels, within one
pixel of each other (rays are pixel-major, so a share is a pixel span). So
no rank holds padding rays (the JAX package pads the ray axis to a multiple
of the device count and kills the padding lanes), and every pixel's sum
comes from one rank while the others add zeros: the group's framebuffer has
the bits of the single-device one.

- Forward renders (``render_pass_sharded``, ``render_framebuffer_sharded``)
  trace a rank's share through the pipeline's own block tracer
  (``pipeline.render_pass`` over a pixel range): 2^18-ray blocks through
  the closest-hit kernels, or one shade-kernel launch for a brute scene. A
  size-1 mesh gives ``render_framebuffer``'s bits.
- Training (``sharded_loss``, ``make_sharded_train_step``) traces a rank's
  share as one differentiable wavefront, as ``diff.render_radiance`` traces
  a whole pass. The sums are explicit in both directions: ``_AllReduceSum``
  sums the framebuffer in its forward pass and hands the (replicated)
  cotangent back unchanged, so each rank's parameter gradients are those of
  its own share, and ``all_reduce_grads`` sums them. (An all-reduce whose
  backward all-reduces the cotangent again would give a loss replicated on
  N ranks N times its gradient.)

``cli_render`` is one rank's part of the command line's ``--mesh N``: in the
calling process for N = 1, in each rank ``cli_worker`` spawns for N > 1.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Tuple

import torch

from cuda_raytracer_tpu_torch.models.scene import Scene
from cuda_raytracer_tpu_torch.parallel.mesh import Mesh, init_group, shutdown
from cuda_raytracer_tpu_torch.render import diff, packed, pipeline, wavefront


def pixel_share(num_pixels: int, mesh: Mesh) -> Tuple[int, int]:
    """The pixels ``[lo, hi)`` this rank traces: contiguous, whole pixels,
    shares within one pixel of each other."""
    return (num_pixels * mesh.rank // mesh.size,
            num_pixels * (mesh.rank + 1) // mesh.size)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_pass_sharded(
    scene: Scene,
    mesh: Mesh,
    rays_per_pixel: int,
    pass_seed,
    bounces: Optional[int] = None,
    sort_rays: Optional[bool] = None,
    reparam: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over every pixel, the rays shared across the mesh → (raw-sum
    framebuffer (pixels, 3), suspect-ray count (int64)), both summed over
    the group, the same on every rank."""
    cfg = scene.config
    bounces = cfg.bounces if bounces is None else bounces
    sort_rays = cfg.sort_rays if sort_rays is None else sort_rays
    local = torch.zeros((scene.num_pixels, 3), dtype=torch.float32, device=scene.device)
    local, suspect = pipeline.render_pass(
        scene, local, int(pass_seed), rays_per_pixel, bounces, sort_rays, reparam,
        pixels=pixel_share(scene.num_pixels, mesh))
    suspect = torch.as_tensor(suspect, dtype=torch.int64, device=scene.device).reshape(1)
    return mesh.all_reduce(local), mesh.all_reduce(suspect)


def render_framebuffer_sharded(scene: Scene, mesh: Mesh) -> torch.Tensor:
    """The whole multi-pass render, sharded (the distributed form of
    ``pipeline.render_framebuffer``): pass seeds from the remaining-sample
    count; the closest-hit exactness certificate enforced after the pass
    loop (a suspect ray raises)."""
    cfg = scene.config
    framebuffer = torch.zeros((scene.num_pixels, 3), dtype=torch.float32, device=scene.device)
    suspect_total = torch.zeros(1, dtype=torch.int64, device=scene.device)
    remaining = cfg.rays_per_pixel
    while remaining:
        chunk = min(remaining, cfg.max_rays_per_pixel_per_pass)
        remaining -= chunk
        contribution, suspect = render_pass_sharded(scene, mesh, chunk, remaining,
                                                    cfg.bounces, cfg.sort_rays)
        framebuffer = framebuffer + contribution
        suspect_total = suspect_total + suspect
    suspects = int(suspect_total)  # one device sync, after the pass loop
    if suspects:
        raise RuntimeError(
            f"closest-hit exactness certificate failed: {suspects} suspect ray-bounces "
            "(packet pair-budget overflow); raise RenderConfig.packet_cap")
    return framebuffer


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the cotangent unchanged.
    Every rank computes the same loss from the summed framebuffer, so the
    cotangent is already the full one on each rank; summing it again would
    scale every gradient by the group's size."""

    @staticmethod
    def forward(ctx, tensor, mesh):
        return mesh.all_reduce(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _trace_share(scene: Scene, mesh: Mesh, rays_per_pixel: int, pass_seed: int,
                 bounces: int, reparam: bool = False, checkpoint_bounces: bool = True):
    """This rank's share of one pass as one wavefront → (full-size local
    radiance sums (pixels, 3), differentiable; suspect count)."""
    lo, hi = pixel_share(scene.num_pixels, mesh)
    local = torch.zeros((scene.num_pixels, 3), dtype=torch.float32, device=scene.device)
    if hi == lo:
        return local, 0
    sort_rays = scene.config.sort_rays
    state, suspect = packed.trace_camera(
        scene, lo * rays_per_pixel, (hi - lo) * rays_per_pixel, rays_per_pixel, pass_seed,
        bounces, sort_rays, reparam=reparam, checkpoint_bounces=checkpoint_bounces)
    acc = wavefront.accumulate_radiance(
        state, rays_per_pixel, hi - lo,
        ordered=wavefront.wavefront_ordered(scene, (hi - lo) * rays_per_pixel, bounces, sort_rays))
    return torch.nn.functional.pad(acc, (0, 0, lo, scene.num_pixels - hi)), suspect


def sharded_loss(
    params: diff.SceneParams,
    scene: Scene,
    mesh: Mesh,
    target: torch.Tensor,  # (pixels, 3) radiance target, the same on every rank
    rays_per_pixel: int,
    pass_seed: int,
    bounces: int,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
) -> torch.Tensor:
    """The L2 inverse-rendering loss of ``diff.loss_against_target`` on the
    framebuffer summed over the group, the same on every rank. Its backward
    pass gives each rank the gradient of its own share of the rays;
    ``all_reduce_grads`` sums those into the loss's gradient."""
    scene = diff.merge_params(scene, params)
    local, _ = _trace_share(scene, mesh, rays_per_pixel, pass_seed, bounces, reparam,
                            checkpoint_bounces)
    radiance = _AllReduceSum.apply(local, mesh) / rays_per_pixel
    return torch.mean((radiance - target) ** 2)


def all_reduce_grads(mesh: Mesh, leaves) -> None:
    """Sum each leaf's ``.grad`` over the group, in place; a leaf the loss
    does not reach gets a zero gradient first."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        mesh.all_reduce(p.grad)


def sharded_loss_and_grad(
    scene: Scene,
    mesh: Mesh,
    target: torch.Tensor,
    pass_seed: int = 0,
    rays_per_pixel: int = 4,
    bounces: int = 3,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
):
    """(loss, SceneParams of gradients) of ``sharded_loss`` at the scene's
    own parameters, the gradients summed over the group: the sharded form
    of ``diff.render_and_grad``."""
    params = diff.make_leaves(diff.split_params(scene)[0])
    loss = sharded_loss(params, scene, mesh, target, rays_per_pixel, pass_seed, bounces,
                        reparam, checkpoint_bounces)
    loss.backward()
    leaves = diff.param_leaves(params)
    all_reduce_grads(mesh, leaves)
    return loss.detach(), diff._from_leaves([p.grad for p in leaves])


def _audit_sharded(scene: Scene, mesh: Mesh, rays_per_pixel: int, bounces: int) -> int:
    """Suspect rays of one pass traced as the sharded train step traces it
    (each rank's share one wavefront), summed over the group."""
    with torch.no_grad():
        _, suspect = _trace_share(scene, mesh, rays_per_pixel, 0, bounces)
    total = torch.as_tensor(suspect, dtype=torch.int64, device=scene.device).reshape(1)
    return int(mesh.all_reduce(total))


def make_sharded_train_step(
    scene: Scene,
    mesh: Mesh,
    optimizer: torch.optim.Optimizer,
    rays_per_pixel: int,
    bounces: int,
    reparam: bool = False,
    live_schedule="auto",
    checkpoint_bounces: bool = True,
):
    """The sharded inverse-rendering train step: ``step(params, target,
    seed) -> loss``, as ``diff.make_train_step`` (``optimizer`` built over
    ``diff.param_leaves(params)``, leaves updated in place), with the loss
    on the framebuffer summed over the group and the gradients summed over
    it before ``optimizer.step()``, so every rank takes the same step.

    ``live_schedule``: ``"auto"`` calibrates a static live-prefix schedule
    on the whole pass (``diff.calibrate_live_schedule``, the same on every
    rank); an explicit tuple pins one; None keeps the dynamic prefix. A
    schedule is kept only if one pass traced in shares, as the step traces
    it, reports no suspect ray on any rank: a share of the image can keep
    more rays alive than the whole image's average."""
    if live_schedule == "auto":
        live_schedule = diff.calibrate_live_schedule(scene, rays_per_pixel=rays_per_pixel,
                                                     bounces=bounces)
    if live_schedule:
        audited = scene.with_config(live_schedule=tuple(live_schedule))
        if _audit_sharded(audited, mesh, rays_per_pixel, bounces) == 0:
            scene = audited
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}

    def train_step(params: diff.SceneParams, target: torch.Tensor, seed: int) -> torch.Tensor:
        leaves = diff.param_leaves(params)
        if any(id(p) not in owned for p in leaves):
            raise ValueError("the optimizer must be built over param_leaves(params)")
        optimizer.zero_grad(set_to_none=True)
        loss = sharded_loss(params, scene, mesh, target, rays_per_pixel, seed, bounces,
                            reparam, checkpoint_bounces)
        loss.backward()
        all_reduce_grads(mesh, leaves)
        optimizer.step()
        return loss.detach()

    train_step.scene = scene  # the audited scene the step renders
    return train_step


def scaling_report(scene: Scene, mesh: Mesh, rays_per_pixel: int = 4,
                   repeats: int = 3) -> dict:
    """Primary paths per second of one pass on one rank (rank 0 alone) and
    on the whole mesh, and the scaling efficiency between them; the same
    dict on every rank. Host clock around work that ends in a device
    synchronisation."""
    single = Mesh(None, 0, 1, mesh.device)
    paths = scene.num_pixels * rays_per_pixel
    results = {}
    for label, sub in (("1dev", single), (f"{mesh.size}dev", mesh)):
        seconds = torch.zeros(1, dtype=torch.float64, device=mesh.device)
        if sub is mesh or mesh.rank == 0:
            def run():
                render_pass_sharded(scene, sub, rays_per_pixel, 0)
                _sync(mesh.device)

            run()  # warm-up: kernel loads, allocator blocks
            start = time.perf_counter()
            for _ in range(repeats):
                run()
            seconds[0] = (time.perf_counter() - start) / repeats
        # The slowest rank's time (rank 0's alone for the single run).
        mesh.all_reduce(seconds, op=torch.distributed.ReduceOp.MAX)
        results[label] = paths / float(seconds[0])
    results["scaling_efficiency"] = results[f"{mesh.size}dev"] / (mesh.size * results["1dev"])
    return results


def cli_render(mesh: Mesh, scene_path: str, load_kwargs: dict, out: str, apply_bloom: bool,
               metrics_scene) -> None:
    """One rank's share of ``python -m cuda_raytracer_tpu_torch <scene> --mesh N``
    on ``mesh``: load the scene on the rank's device and render it sharded;
    rank 0 writes the PNG and, when ``metrics_scene`` is set, the metrics
    line (phases ``load_scene`` and ``render_sharded``, the render's kernel
    launches as ``launches_<kernel>`` counters, and rank 0's loop spans and
    counters, ``utils/metrics``). A size-1 mesh runs it in the calling
    process, as the JAX CLI does."""
    from cuda_raytracer_tpu_torch.models.scene_dsl import load_scene
    from cuda_raytracer_tpu_torch.ops.kernels.counts import launch_counts, launches_since
    from cuda_raytracer_tpu_torch.utils.metrics import Metrics, attached
    from cuda_raytracer_tpu_torch.utils.png import write_png

    metrics = Metrics()
    with metrics.phase("load_scene"):
        scene = load_scene(scene_path, device=mesh.device, **load_kwargs)
    before = launch_counts()
    with metrics.phase("render_sharded"), attached(metrics):
        framebuffer = render_framebuffer_sharded(scene, mesh)
        _sync(mesh.device)
    for name, n in launches_since(before).items():
        metrics.count(f"launches_{name}", n)
    if mesh.rank == 0:
        print(f"Scene: {scene.sphere_count} spheres, {scene.triangle_count} triangles, "
              f"{scene.bvh_node_count} BVH nodes", file=sys.stderr)
        write_png(out, pipeline.render_image(scene, apply_bloom=apply_bloom,
                                             framebuffer=framebuffer))
        rate = metrics.throughput("paths_per_s_sharded",
                                  scene.num_pixels * scene.config.rays_per_pixel,
                                  "render_sharded")
        print(f"sharded over {mesh.size} ranks took {metrics.phases['render_sharded']:.2f}s"
              + (f" ({rate:.3e} paths/s)" if rate else ""), file=sys.stderr)
        if metrics_scene is not None:
            metrics.emit(stream=sys.stderr, scene=metrics_scene, mesh=mesh.size)


def cli_worker(rank: int, coordinator: str, size: int, device_type: str, scene_path: str,
               load_kwargs: dict, out: str, apply_bloom: bool, metrics_scene) -> None:
    """One spawned rank of ``--mesh N`` (N > 1), started by
    ``torch.multiprocessing`` with its rank first: join the group on
    ``cuda:rank`` (NCCL) or the CPU (gloo), then ``cli_render``."""
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    mesh = init_group(coordinator, size, rank, device)
    try:
        cli_render(mesh, scene_path, load_kwargs, out, apply_bloom, metrics_scene)
    finally:
        shutdown()
