"""One run of one cell: set-up, the measured window, then the comparison
with the plain reference (``rtbench/reference``).

The program under test is ``cuda_raytracer_tpu_torch``, entered as a user
enters it: scene text through ``models.scene_dsl`` into a ``Scene``, then
``render.pipeline.render_framebuffer`` and ``render_image`` for an image,
or the step of ``render.diff.make_train_step`` for inverse rendering.
From it the harness takes only its outputs (framebuffers, image bytes,
losses, the optimizer's state and parameters), read once the window has
closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from rtbench.core import trace as trace_mod
from rtbench.core.spec import Cell
from rtbench.reference import dsl as ref_dsl
from rtbench.reference import post as ref_post
from rtbench.reference import tracer as ref_tracer
from rtbench.reference import train as ref_train

TRACE_SECONDS = 2.0  # the profiler holds whole images or steps until this much has passed
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_raytracer_tpu")


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]
    checks: Dict[str, dict]  # name → {"value", "limit"}
    attempted: int
    failed: int
    memory_peak_bytes: int
    traced: Optional[dict] = None  # trace_mod.reduce's dict
    trace: Optional[trace_mod.Trace] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seed_streams(seed: int):
    """Independent generators for the scene, the check's sample, the
    traffic and the choice of the image checked in full."""
    seq = np.random.SeedSequence(seed % 2 ** 64)
    return [np.random.default_rng(s) for s in seq.spawn(4)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def scene_text(cell: Cell, rng, width: int, height: int, rays_per_pixel: int, tmp: Path) -> str:
    """The cell's scene text from the seed, its files written into ``tmp``."""
    text, files = cell.scene_module().generate(cell.config["scene_params"], rng)
    for name, sky in files.items():
        ref_dsl.write_pfm(str(tmp / name), sky)
    cfg = cell.config
    return text + f"image {width} {height} {rays_per_pixel} {cfg['bounces']} {cfg['exposure']}\n"


def load_program_scene(cell: Cell, text: str, tmp: Path, device):
    """Parse and assemble through the port's loader → (parsed, scene, seconds)."""
    from cuda_raytracer_tpu_torch.models import scene_dsl

    start = time.perf_counter()
    parsed = scene_dsl.parse_scene_text(text, base_dir=str(tmp), filename=cell.name)
    scene = scene_dsl.assemble_scene(parsed, config_overrides=cell.config["render"],
                                     device=device)
    sync(device)
    return parsed, scene, time.perf_counter() - start


def check_pixels(cell: Cell, rng, width: int, height: int, device) -> torch.Tensor:
    """The pixels the comparison traces again, drawn from the seed."""
    count = min(cell.limits["check_pixels"], width * height)
    return torch.from_numpy(np.sort(rng.choice(width * height, size=count, replace=False))).to(
        device)


def train_inputs(cell: Cell, seed: int):
    """(scene generator, starting albedo, target's pass seed, first step's
    pass seed) of a train cell, from the seed."""
    rng_scene, _, rng_traffic, _ = seed_streams(seed)
    traffic = cell.traffic
    start_albedo = rng_traffic.uniform(traffic["start_albedo_low"],
                                       traffic["start_albedo_high"]).astype(np.float32)
    target_seed = int(rng_traffic.integers(0, 2 ** 31))
    return rng_scene, start_albedo, target_seed, int(rng_traffic.integers(0, 2 ** 31 - 2 ** 20))


def reference_leaves(cell: Cell, ref_scene, start_albedo: np.ndarray, device):
    """The reference's true and starting leaves: the scene's, with the
    object's diffuse albedo set to ``start_albedo`` to start from."""
    true = dict(ref_tracer.material_tensors(ref_scene, device),
                environment_map=torch.from_numpy(ref_scene.environment_map).to(device))
    diffuse = true["diffuse"].clone()
    diffuse[ref_scene.material_names.index(cell.scene_module().OBJECT_MATERIAL)] = \
        torch.from_numpy(start_albedo).to(device)
    return true, dict(true, diffuse=diffuse)


def note(message: str) -> None:
    print(f"rtbench: {message}", file=sys.stderr, flush=True)


def _check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def span(name: str, on: bool):
    """A profiler span of the harness around a call into the program, in
    traced runs only."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class _Profiler:
    """torch.profiler over whole images or steps, from the first of the
    window until TRACE_SECONDS have passed. It starts before the window,
    so its own start-up does not fall into it."""

    def __init__(self, enabled: bool):
        self.enabled, self.prof, self.span, self.units, self.start = enabled, None, None, 0, 0.0
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()

    def before(self) -> None:
        if self.enabled and self.units == 0 and self.span is None:
            from torch.profiler import record_function

            self.span = record_function(trace_mod.WINDOW_SPAN)
            self.span.__enter__()
            self.start = time.perf_counter()

    def after(self, device) -> None:
        if self.span is not None:
            self.units += 1
            if time.perf_counter() - self.start >= TRACE_SECONDS:
                sync(device)
                self.span.__exit__(None, None, None)
                self.prof.stop()
                self.span = None

    def reduce(self) -> Optional[dict]:
        if self.prof is None:
            return None
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.prof.stop()
            self.span = None
        return trace_mod.reduce(self.prof) if self.units else None


def run_image(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
              started: float) -> Outcome:
    from cuda_raytracer_tpu_torch.render import pipeline

    cfg, traffic = cell.config, cell.traffic
    W, H, spp = cfg["width"], cfg["height"], traffic["rays_per_pixel"]
    rng_scene, rng_check, _, rng_pick = seed_streams(seed)
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmpdir:
        tmp = Path(tmpdir)
        text = scene_text(cell, rng_scene, W, H, spp, tmp)
        _, scene, scene_s = load_program_scene(cell, text, tmp, device)
        note(f"scene text and load {time.perf_counter() - started:.3f} s, "
             f"load alone {scene_s:.3f} s")
        warm = scene.with_config(rays_per_pixel=min(spp, cfg["render"].get(
            "max_rays_per_pixel_per_pass", 20)))
        warm_fb = pipeline.render_framebuffer(warm)
        pipeline.render_image(warm, framebuffer=warm_fb)
        index = check_pixels(cell, rng_check, W, H, device)
        warm_fb.index_select(0, index)
        del warm_fb
        pick = random.Random(int(rng_pick.integers(2 ** 63)))
        sync(device)
        setup_s = time.perf_counter() - started

        prof = _Profiler(trace)
        walls: List[float] = []
        post_ms: List[float] = []
        samples = []
        kept = None
        window_start = time.perf_counter()
        deadline = window_start + seconds
        while True:
            prof.before()
            t0 = time.perf_counter()
            with span("rtbench.framebuffer", trace):
                fb = pipeline.render_framebuffer(scene)
                if trace:
                    sync(device)
            p0 = time.perf_counter()
            with span("rtbench.post", trace):
                img = pipeline.render_image(scene, framebuffer=fb)
            t1 = time.perf_counter()
            if trace:
                post_ms.append((t1 - p0) * 1e3)
            walls.append(t1 - t0)
            samples.append(fb.index_select(0, index))
            if pick.randrange(len(walls)) == 0:  # one image, uniform over the window's
                kept = (fb, img)
            prof.after(device)
            if t1 >= deadline:
                break
        sync(device)
        window_s = time.perf_counter() - window_start
        note(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, {len(walls)} images")
        reduce_start = time.perf_counter()
        traced = prof.reduce()
        if trace:
            note(f"trace of {prof.units} images reduced in "
                 f"{time.perf_counter() - reduce_start:.3f} s")
        found = forbidden_modules()
        peak = memory_peak(device)
        del fb, img, scene, warm
        if device.type == "cuda":
            torch.cuda.empty_cache()

        ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
    ref_start = time.perf_counter()
    geo = ref_tracer.geometry(ref_scene, device)
    mats = ref_tracer.material_tensors(ref_scene, device)
    env = torch.from_numpy(ref_scene.environment_map).to(device)
    with torch.no_grad():
        ref = ref_tracer.pixel_sums(geo, mats, env, index, spp, cfg["bounces"],
                                    cfg["render"].get("max_rays_per_pixel_per_pass", 20))
        ref_bytes = ref_post.image_bytes(kept[0], W, H, spp, cfg["exposure"])
    note(f"reference {time.perf_counter() - ref_start:.3f} s")
    scale = float(ref.abs().sum())
    gaps = [float((s.float() - ref).abs().sum()) / scale for s in samples]
    limits = cell.limits["limits"]
    checks = {
        "fb_rel_l1": _check(max(gaps), limits["fb_rel_l1"]),
        "post_bytes_off": _check(float(np.mean(ref_bytes != kept[1])), limits["post_bytes_off"]),
    }
    metrics = {"image_s": window_s / len(walls),
               "image_p95_s": float(np.percentile(walls, 95)), "setup_s": setup_s}
    if found:
        raise ForbiddenModules(found)
    return Outcome(metrics, checks, attempted=len(walls),
                   failed=sum(g > limits["fb_rel_l1"] for g in gaps),
                   memory_peak_bytes=peak, traced=traced,
                   trace=_trace(cell, traced, prof.units, post_ms, scene_s))


def _trace(cell: Cell, traced: Optional[dict], units: int, post_ms, scene_s):
    if traced is None:
        return trace_mod.Trace(cell.kind, units, [], 0.0, 0.0, post_ms, scene_s)
    return trace_mod.Trace(cell.kind, units, traced["device_events"], traced["busy_s"],
                           traced["window_s"], post_ms, scene_s)


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


def _leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor], keep: List[bool]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; leaves with ``keep`` False are left out."""
    p = [float(torch.linalg.vector_norm(x.float())) for x in prog]
    r = [float(torch.linalg.vector_norm(x.float())) for x in ref]
    kept = [i for i, k in enumerate(keep) if k]
    median = statistics.median([r[i] for i in kept])
    return max(abs(p[i] - r[i]) / max(r[i], median) for i in kept) if median > 0 else \
        max(abs(p[i] - r[i]) for i in kept)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of the program's first steps
    against the reference's (``prog`` and ``ref`` as ``ref_train.follow``
    returns them, leaves as lists in ``ref_train.LEAVES`` order). Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the change: Adam moves them by round-off alone."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grads = [ref["first_grad"][k] for k in ref_train.LEAVES]
    norms = [float(torch.linalg.vector_norm(g)) for g in grads]
    median = statistics.median(norms)
    moving = [n >= 1e-3 * median for n in norms]
    return dict(
        loss_gap=loss,
        grad_gap=_leaf_gaps(prog["first_grad"], grads, [True] * len(grads)),
        change_gap=_leaf_gaps(prog["change"], [ref["change"][k] for k in ref_train.LEAVES],
                              moving),
    )


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
              started: float) -> Outcome:
    from cuda_raytracer_tpu_torch.render import diff

    cfg, traffic = cell.config, cell.traffic
    W, H, spp, bounces = traffic["width"], traffic["height"], traffic["rays_per_pixel"], \
        cfg["bounces"]
    rng_scene, start_albedo, target_seed, base = train_inputs(cell, seed)
    checked = traffic["checked_steps"]
    lr = traffic["learning_rate"]
    with tempfile.TemporaryDirectory(prefix="rtbench-") as tmpdir:
        tmp = Path(tmpdir)
        text = scene_text(cell, rng_scene, W, H, spp, tmp)
        parsed, scene, scene_s = load_program_scene(cell, text, tmp, device)
        true_params, _ = diff.split_params(scene)
        with torch.no_grad():
            target = diff.render_radiance(true_params, scene, target_seed, spp, bounces)
        arrays = diff.params_to_numpy(true_params)
        row = parsed.material_names.index(cell.scene_module().OBJECT_MATERIAL)
        arrays["materials.diffuse_albedo"][row] = start_albedo
        params = diff.params_from_numpy(arrays, device, requires_grad=True)
        leaves = diff.param_leaves(params)
        optimizer = torch.optim.Adam(leaves, lr=lr)
        step = diff.make_train_step(scene, optimizer, spp, bounces, live_schedule="auto",
                                    checkpoint_bounces=True)
        start = [p.detach().clone() for p in leaves]
        losses, first_grad = [], None
        beta1 = optimizer.param_groups[0]["betas"][0]
        for k in range(checked):
            losses.append(step(params, target, base + k))
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) · gradient;
                # no moment means the optimizer never took the gradient.
                first_grad = [optimizer.state[p]["exp_avg"].detach() / (1 - beta1)
                              if "exp_avg" in optimizer.state.get(p, {})
                              else torch.zeros_like(p) for p in leaves]
        change = [p.detach() - s for p, s in zip(leaves, start)]
        sync(device)
        setup_s = time.perf_counter() - started

        prof = _Profiler(trace)
        steps = 0
        window_start = time.perf_counter()
        deadline = window_start + seconds
        while True:
            prof.before()
            with span("rtbench.step", trace):
                step(params, target, base + checked + steps)
            steps += 1
            prof.after(device)
            if time.perf_counter() >= deadline:
                break
        sync(device)
        window_s = time.perf_counter() - window_start
        note(f"set-up {setup_s:.3f} s (scene {scene_s:.3f} s); window {window_s:.3f} s, "
             f"{steps} steps")
        reduce_start = time.perf_counter()
        traced = prof.reduce()
        if trace:
            note(f"trace of {prof.units} steps reduced in "
                 f"{time.perf_counter() - reduce_start:.3f} s")
        found = forbidden_modules()
        peak = memory_peak(device)
        prog = dict(losses=[float(x) for x in losses], first_grad=first_grad, change=change)
        del step, optimizer, params, leaves, target, scene, true_params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref_scene = ref_dsl.parse(text, base_dir=str(tmp))
    ref_start = time.perf_counter()
    geo = ref_tracer.geometry(ref_scene, device)
    true_leaves, start_leaves = reference_leaves(cell, ref_scene, start_albedo, device)
    ref = ref_train.follow(geo, true_leaves, start_leaves, W * H, spp, bounces, target_seed,
                           [base + k for k in range(checked)], lr)
    note(f"reference {time.perf_counter() - ref_start:.3f} s")
    numbers = train_numbers(prog, ref)
    limits = cell.limits["limits"]
    checks = {name: _check(value, limits[name]) for name, value in numbers.items()}
    if found:
        raise ForbiddenModules(found)
    return Outcome({"step_s": window_s / steps, "setup_s": setup_s}, checks,
                   attempted=steps, failed=sum(c["value"] > c["limit"] for c in checks.values()),
                   memory_peak_bytes=peak, traced=traced,
                   trace=_trace(cell, traced, prof.units, [], scene_s))


RUNNERS = {"image": run_image, "train": run_train}
