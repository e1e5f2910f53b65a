"""The kernel wrappers' launch counters, read and reset together.

Each wrapper adds one to its counter where it launches its kernel on a CUDA
tensor, and nowhere else; a run that reads these before and after its work
shows which kernels its path went through.
"""

from __future__ import annotations


def _counters():
    from cuda_raytracer_tpu_torch.ops.kernels import (
        bounce, cull, fused, fused1, rays, shade, sweep, traverse)

    return {"shade_trace": (shade, "LAUNCHES"), "cull_tiles": (cull, "LAUNCHES"),
            "cull_gated": (cull, "LAUNCHES_GATED"),
            "fused_closest_hit": (fused, "LAUNCHES"),
            "fused1_closest_hit": (fused1, "LAUNCHES"),
            "fused1_closest_hit_pack2": (fused1, "LAUNCHES_PACK2"),
            "sweep_pairs": (sweep, "LAUNCHES"), "shade_rows": (bounce, "LAUNCHES"),
            "rays_setup": (rays, "LAUNCHES_SETUP"), "ray_keys": (rays, "LAUNCHES_KEYS"),
            "cullhit_keys": (rays, "LAUNCHES_CULLHIT"), "pcg_draws": (rays, "LAUNCHES_DRAWS"),
            "camera_rows": (rays, "LAUNCHES_CAMERA"), "reorder_rows": (rays, "LAUNCHES_REORDER"),
            "bvh_walk": (traverse, "LAUNCHES")}


def launch_counts() -> dict:
    """{kernel name: launches so far in this process}."""
    return {name: getattr(module, attr) for name, (module, attr) in _counters().items()}


def zero_launch_counts() -> None:
    for module, attr in _counters().values():
        setattr(module, attr, 0)


def launches_since(before: dict) -> dict:
    """{kernel name: launches since ``before`` (a ``launch_counts()``)}, the
    kernels that launched only."""
    now = launch_counts()
    return {name: now[name] - before[name] for name in now if now[name] != before[name]}
