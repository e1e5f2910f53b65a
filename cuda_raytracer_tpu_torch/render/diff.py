"""Differentiable rendering: pixel gradients → material parameters and the sky map (counterpart of ``cuda_raytracer_tpu/render/diff.py``).

A scalar loss on the rendered radiance yields gradients for every material
channel (diffuse, specular, emitted, and metallicity through the
score-function term; with ``reparam=True`` pathwise gradients for roughness
and ior) and for the environment map. The estimator is the JAX package's:
sampling decisions and RNG draws are detached, radiance is a product chain
of gathered albedos, and the wavefront's gradient cuts sit where the JAX
package stops gradients (``render/wavefront.py``).

PyTorch idiom: parameters are leaf tensors held in a ``SceneParams``
(``make_leaves`` makes them), gradients come from ``torch.autograd``, each
bounce's shading is checkpointed with ``torch.utils.checkpoint``, and the
train step drives a ``torch.optim`` optimizer over ``param_leaves``.
``torch.optim.Adam(lr, betas, eps)`` takes the same step as ``optax.adam``
with the same numbers. ``params_to_numpy`` / ``params_from_numpy`` carry
parameters across packages under the JAX field names.

On the card the mesh path's closest hits (the BVH walk under "auto", the
packet kernels when asked for) run in the forward pass only: the backward pass recomputes the shading from the
saved hit records and never launches a closest-hit kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models.scene import Materials, Scene
from cuda_raytracer_tpu_torch.render import packed, wavefront
from cuda_raytracer_tpu_torch.utils import metrics as recording
from cuda_raytracer_tpu_torch.utils.backend import resolve_device

MATERIAL_FIELDS = tuple(f.name for f in dataclasses.fields(Materials))


class SceneParams(NamedTuple):
    """The differentiable leaves of a Scene."""

    materials: Materials
    environment_map: torch.Tensor


def split_params(scene: Scene) -> Tuple[SceneParams, Scene]:
    """The differentiable parameters of ``scene`` (its own tensors) and the
    scene; ``merge_params`` puts other tensors in their place."""
    return SceneParams(scene.materials, scene.environment_map), scene


def merge_params(scene: Scene, params: SceneParams) -> Scene:
    return scene.replace(materials=params.materials, environment_map=params.environment_map)


def param_leaves(params: SceneParams) -> List[torch.Tensor]:
    """The seven tensors of ``params``: the material fields in
    ``MATERIAL_FIELDS`` order, then the environment map."""
    return [getattr(params.materials, f) for f in MATERIAL_FIELDS] + [params.environment_map]


def _from_leaves(leaves) -> SceneParams:
    return SceneParams(Materials(**dict(zip(MATERIAL_FIELDS, leaves[:-1]))), leaves[-1])


def make_leaves(params: SceneParams) -> SceneParams:
    """Fresh leaf copies of ``params`` that require grad: what an optimizer
    updates in place."""
    return _from_leaves([p.detach().clone().requires_grad_(True) for p in param_leaves(params)])


def params_to_numpy(params: SceneParams) -> Dict[str, np.ndarray]:
    """``{"materials.<field>": ..., "environment_map": ...}`` float32 arrays,
    the JAX ``SceneParams`` field names."""
    names = [f"materials.{f}" for f in MATERIAL_FIELDS] + ["environment_map"]
    return {n: p.detach().cpu().numpy().copy() for n, p in zip(names, param_leaves(params))}


def params_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                      requires_grad: bool = False) -> SceneParams:
    """Inverse of ``params_to_numpy``, on ``device`` (default CUDA)."""
    device = resolve_device(device)
    names = [f"materials.{f}" for f in MATERIAL_FIELDS] + ["environment_map"]
    leaves = [torch.tensor(np.asarray(arrays[n], dtype=np.float32), device=device)
              .requires_grad_(requires_grad) for n in names]
    return _from_leaves(leaves)


def render_radiance(
    params: SceneParams,
    scene: Scene,
    pass_seed: int,
    rays_per_pixel: int,
    bounces: int,
    sort_rays: Optional[bool] = None,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
) -> torch.Tensor:
    """One differentiable pass → per-pixel mean radiance (pixels, 3),
    normalised by ``rays_per_pixel`` so losses do not depend on the sample
    count. ``sort_rays=None`` follows the scene config. The closest-hit
    certificate is not enforced here (it would force a check per step);
    ``check_radiance_exact`` audits a training configuration once."""
    if sort_rays is None:
        sort_rays = scene.config.sort_rays
    scene = merge_params(scene, params)
    ray_id = torch.arange(scene.num_pixels * rays_per_pixel, dtype=torch.int32,
                          device=scene.device)
    state = wavefront.make_initial_state(scene, ray_id, rays_per_pixel, pass_seed)
    state, _suspect = packed.trace_wavefront(
        scene, state, pass_seed, bounces, sort_rays, reparam=reparam,
        checkpoint_bounces=checkpoint_bounces,
    )
    acc = wavefront.accumulate_radiance(
        state, rays_per_pixel, scene.num_pixels,
        ordered=wavefront.wavefront_ordered(scene, ray_id.shape[0], bounces, sort_rays),
    )
    return acc / rays_per_pixel


def check_radiance_exact(scene: Scene, pass_seed: int = 0, rays_per_pixel: int = None,
                         bounces: int = None) -> int:
    """One-shot audit of a training configuration: traces one full pass
    and returns its suspect-ray count (packet pair-budget overflow; 0 means
    every closest hit is certified exact)."""
    cfg = scene.config
    rays_per_pixel = rays_per_pixel or cfg.rays_per_pixel
    bounces = bounces or cfg.bounces
    with torch.no_grad():
        ray_id = torch.arange(scene.num_pixels * rays_per_pixel, dtype=torch.int32,
                              device=scene.device)
        state = wavefront.make_initial_state(scene, ray_id, rays_per_pixel, pass_seed)
        _, suspect = packed.trace_wavefront(scene, state, pass_seed, bounces, cfg.sort_rays)
    return int(suspect)


def calibrate_live_schedule(scene: Scene, rays_per_pixel: int = None, bounces: int = None,
                            seeds=(0, 1), margin: float = 1.25) -> tuple:
    """Per-bounce live bounds of full passes (the largest over ``seeds``),
    widened by ``margin``, as a static live-prefix schedule
    (``config.live_schedule``): one divisor per bounce, fractional so the
    prefix lands on the calibrated bound. The schedule certificate still
    catches a pass that outgrows it."""
    cfg = scene.config
    rays_per_pixel = rays_per_pixel or cfg.rays_per_pixel
    bounces = bounces or cfg.bounces
    R = scene.num_pixels * rays_per_pixel
    measured = []
    with torch.no_grad():
        for seed in seeds:
            ray_id = torch.arange(R, dtype=torch.int32, device=scene.device)
            state = wavefront.make_initial_state(scene, ray_id, rays_per_pixel, seed)
            measured.append(packed.trace_live_bounds(scene, state, seed, bounces, cfg.sort_rays))
    bounds = np.maximum.reduce([np.asarray(b, dtype=np.int64) for b in measured])
    divisors = []
    for b in range(bounces):
        need = min(R, int(np.ceil(margin * float(bounds[b]))))
        d = R / max(1, need)
        if wavefront.prefix_for_divisor(scene, R, d) >= R:
            d = 1  # the full prefix: the canonical integer form
        divisors.append(d)
    return tuple(divisors)


def loss_against_target(
    params: SceneParams,
    scene: Scene,
    target: torch.Tensor,  # (pixels, 3) radiance target
    pass_seed: int,
    rays_per_pixel: int,
    bounces: int,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
) -> torch.Tensor:
    """L2 inverse-rendering loss in radiance space."""
    rendered = render_radiance(params, scene, pass_seed, rays_per_pixel, bounces,
                               reparam=reparam, checkpoint_bounces=checkpoint_bounces)
    return torch.mean((rendered - target) ** 2)


def _grads(loss: torch.Tensor, leaves) -> List[torch.Tensor]:
    """d loss / d leaves, zeros (not None) for leaves the loss does not reach."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def render_and_grad(
    scene: Scene,
    loss_fn: Optional[Callable] = None,
    target: Optional[torch.Tensor] = None,
    pass_seed: int = 0,
    rays_per_pixel: int = 4,
    bounces: int = 3,
    reparam: bool = False,
    checkpoint_bounces: bool = True,
):
    """(loss, SceneParams of gradients) of ``loss_fn(radiance)`` or, with a
    radiance ``target``, of the built-in L2 loss. Every gradient is a
    tensor: zeros where the loss does not depend on a parameter (roughness
    and ior in detached mode)."""
    if loss_fn is None and target is None:
        raise ValueError("provide loss_fn or target")
    params = make_leaves(split_params(scene)[0])
    if loss_fn is not None:
        loss = loss_fn(render_radiance(params, scene, pass_seed, rays_per_pixel, bounces,
                                       reparam=reparam,
                                       checkpoint_bounces=checkpoint_bounces))
    else:
        loss = loss_against_target(params, scene, target, pass_seed, rays_per_pixel,
                                   bounces, reparam, checkpoint_bounces)
    return loss.detach(), _from_leaves(_grads(loss, param_leaves(params)))


def make_train_step(
    scene: Scene,
    optimizer: torch.optim.Optimizer,
    rays_per_pixel: int,
    bounces: int,
    reparam: bool = False,
    live_schedule="auto",
    checkpoint_bounces: bool = True,
    metrics=None,
):
    """A single-device inverse-rendering train step:
    ``step(params, target, seed) -> loss``.

    ``optimizer`` is a ``torch.optim.Optimizer`` built over
    ``param_leaves(params)`` of the ``SceneParams`` that is passed to every
    step (leaves from ``make_leaves``). A step renders at pass seed
    ``seed``, takes the L2 loss against ``target``, back-propagates, gives
    leaves the loss does not reach a zero gradient (so the optimizer's state
    advances for every leaf, as optax's does), and updates the leaves in
    place with ``optimizer.step()``. It returns the loss, detached.

    ``live_schedule``: ``"auto"`` calibrates a static live-prefix schedule
    for this scene and shape (``calibrate_live_schedule``) and keeps it only
    if one audited pass (``check_radiance_exact``) reports no suspect; a
    tuple pins a schedule the same way; None keeps the dynamic prefix.

    A step's three phases are spans (``utils/metrics``): ``rt.step.forward``
    (the render and the loss, building the graph), ``rt.step.backward``
    (``loss.backward()``) and ``rt.step.adam`` (the zero gradients and
    ``optimizer.step()``), recorded into ``metrics`` (a
    ``utils.metrics.Metrics``, attached for every step) or, while a
    ``torch.profiler`` records, into ``utils/metrics.PROFILED``."""
    if live_schedule == "auto":
        live_schedule = calibrate_live_schedule(scene, rays_per_pixel=rays_per_pixel,
                                                bounces=bounces)
    if live_schedule:
        audited = scene.with_config(live_schedule=tuple(live_schedule))
        if check_radiance_exact(audited, rays_per_pixel=rays_per_pixel, bounces=bounces) == 0:
            scene = audited
        # else: a stale or tight schedule; keep the dynamic prefix (exact).
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}

    def train_step(params: SceneParams, target: torch.Tensor, seed: int) -> torch.Tensor:
        leaves = param_leaves(params)
        if any(id(p) not in owned for p in leaves):
            raise ValueError("the optimizer must be built over param_leaves(params)")
        optimizer.zero_grad(set_to_none=True)
        with recording.attached(metrics):
            with recording.span("rt.step.forward"):
                loss = loss_against_target(params, scene, target, seed, rays_per_pixel,
                                           bounces, reparam, checkpoint_bounces)
            with recording.span("rt.step.backward"):
                loss.backward()
            with recording.span("rt.step.adam"):
                for p in leaves:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                optimizer.step()
        return loss.detach()

    train_step.scene = scene  # the audited scene the step renders
    return train_step
