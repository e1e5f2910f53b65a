"""Plain inverse-rendering steps: the reference that follows the train
cell's first steps.

A step renders every pixel at ``rays_per_pixel`` samples with one pass
seed, takes the mean over pixels and channels of the squared difference
to the target's per-pixel mean radiance, back-propagates into the seven
leaves (diffuse, specular, emit (M, 3); metallicity, roughness, ior (M,);
the sky map) and takes one Adam step on each (Kingma & Ba; bias-corrected,
eps added to the root of the second moment's estimate). The target is
rendered by this module at the true parameters.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from rtbench.reference import tracer

LEAVES = ("diffuse", "specular", "emit", "metallicity", "roughness", "ior", "environment_map")


def radiance(geo, leaves: Dict[str, torch.Tensor], num_pixels: int, rays_per_pixel: int,
             pass_seed: int, bounces: int) -> torch.Tensor:
    """Per-pixel mean radiance of one pass over every pixel, (pixels, 3)."""
    ray_id = torch.arange(num_pixels * rays_per_pixel, device=geo.material_index.device)
    coll = tracer.trace(geo, leaves, leaves["environment_map"], ray_id, rays_per_pixel,
                        pass_seed, bounces)
    return coll.reshape(num_pixels, rays_per_pixel, 3).sum(dim=1).float() / rays_per_pixel


def follow(geo, true_leaves: Dict[str, torch.Tensor], start_leaves: Dict[str, torch.Tensor],
           num_pixels: int, rays_per_pixel: int, bounces: int, target_seed: int,
           step_seeds: Sequence[int], lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
           fault=None) -> dict:
    """Run ``len(step_seeds)`` steps from ``start_leaves`` → {"losses": [...],
    "first_grad": {leaf: tensor}, "change": {leaf: tensor}} with the
    change after the last step. ``fault`` plants a fault in the steps, for
    reading the comparison's upper limits: ``fault(name, value)`` gets
    "pixels" (the rows the loss averages) and "grads" and returns what the
    step goes on with."""
    with torch.no_grad():
        target = radiance(geo, true_leaves, num_pixels, rays_per_pixel, target_seed, bounces)
    params = {k: v.detach().clone().float() for k, v in start_leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first_grad = None
    for step, seed in enumerate(step_seeds, start=1):
        leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
        rendered = radiance(geo, leaves, num_pixels, rays_per_pixel, seed, bounces)
        rows = torch.arange(num_pixels, device=rendered.device)
        if fault is not None:
            rows = fault("pixels", rows)
        loss = torch.mean((rendered[rows] - target[rows]) ** 2)
        grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g.float()
                 for k, g in zip(LEAVES, grads)}
        if fault is not None:
            grads = fault("grads", grads)
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = grads
        with torch.no_grad():
            for k in LEAVES:
                m[k] = betas[0] * m[k] + (1 - betas[0]) * grads[k]
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * grads[k] * grads[k]
                m_hat = m[k] / (1 - betas[0] ** step)
                v_hat = v2[k] / (1 - betas[1] ** step)
                params[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return dict(losses=losses, first_grad=first_grad,
                change={k: params[k] - start_leaves[k].float() for k in LEAVES})
