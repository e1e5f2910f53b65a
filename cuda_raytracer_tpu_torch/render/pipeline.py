"""End-to-end render orchestration (counterpart of ``cuda_raytracer_tpu/render/pipeline.py``).

The pass loop mirrors the reference (raytracing.cu:222-254): samples are
traced in passes of at most ``max_rays_per_pixel_per_pass`` (20) rays per
pixel, pass seed = samples remaining after the pass, each pass adding raw
radiance sums into one framebuffer. Rays are pixel-major (ray i → pixel
i // rpp), so a block's per-pixel sums are a reshape-sum.

Brute scenes on a CUDA device trace each pass in one launch of the shade
kernel (``ops/kernels/shade.py``); everything else, mesh scenes included,
runs the wavefront path in blocks of at most ``RAY_BLOCK`` rays, where the
closest-hit kernels (the BVH walk, or the packet intersector's) run on a
CUDA device. Every pass boundary can
be checkpointed (``utils/checkpoint.py``) and reported to a progress
callback and a ``utils/metrics.Metrics`` registry. The loops' spans
(``rt.pass``, ``rt.block``, ``rt.accumulate``, ``rt.post`` here; the bounce
loop's in ``render/packed.py`` and ``render/wavefront.py``) and counters go to that registry, or to
``utils/metrics.PROFILED`` while a ``torch.profiler`` records.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cuda_raytracer_tpu_torch.models.scene import Scene
from cuda_raytracer_tpu_torch.ops import bloom as bloom_ops
from cuda_raytracer_tpu_torch.ops import tonemap as tonemap_ops
from cuda_raytracer_tpu_torch.ops.kernels import shade
from cuda_raytracer_tpu_torch.render import packed, wavefront
from cuda_raytracer_tpu_torch.utils import checkpoint as ckpt
from cuda_raytracer_tpu_torch.utils import metrics as recording

# Rays per traced block on the wavefront path. Matching wavefront.SORT_CHUNK
# keeps every block in the whole-wavefront sort regime, where dead-ray
# compaction (wavefront.bounce_schedule) is active; it also bounds the
# (rays × prims) intermediates of the brute intersector.
RAY_BLOCK = 1 << 18
# The multi-sample pass regime (_regime_scene): passes of at least this many
# rays per pixel, over a cluster table of at most REGIME_TABLE_BYTES, take
# the single-kernel fused1 engine on the card.
REGIME_RAYS_PER_PIXEL = 10
REGIME_TABLE_BYTES = 16 << 20


def regime_backend(backend: str, rays_per_pixel: int, cull_split: int, table_bytes: int,
                   device_type: str) -> str:
    """The packet backend a pass of the packet intersector runs with:
    ``"auto"`` becomes ``"fused1"`` for a pass of at least
    REGIME_RAYS_PER_PIXEL rays per pixel, with one box per cluster
    (``cull_split`` 1) and a cluster table of at most REGIME_TABLE_BYTES, on
    a CUDA device; anything else is returned as it is (an explicit backend is
    never overridden; the CPU keeps "auto", which is the xla engine there).
    The default mesh path on a CUDA device walks the BVH and reads no packet
    backend; with ``intersector="packet"`` on an H100 (NVIDIA H100 80GB HBM3,
    700 W) the 126,000-triangle torus at 1000×1000 × 100 spp renders in about
    half the time through fused1 as through cull + fused (PERF.md)."""
    if (backend == "auto" and rays_per_pixel >= REGIME_RAYS_PER_PIXEL and cull_split == 1
            and table_bytes <= REGIME_TABLE_BYTES and device_type == "cuda"):
        return "fused1"
    return backend


def _regime_scene(scene: Scene, rays_per_pixel: int) -> Scene:
    """The scene a pass of ``rays_per_pixel`` samples is traced with: a
    packet scene's backend resolved per pass regime (``regime_backend``), as
    the JAX package's ``render/pipeline._regime_scene`` resolves it on a
    TPU; any other scene as it is, since no other intersector reads it."""
    if wavefront.resolved_intersector(scene) != "packet":
        return scene
    cfg = scene.config
    blocks = scene.cluster_blocks
    backend = regime_backend(cfg.packet_backend, rays_per_pixel, cfg.cull_split,
                             blocks.numel() * blocks.element_size(), scene.device.type)
    return scene if backend == cfg.packet_backend else scene.with_config(packet_backend=backend)


def _render_block(
    scene: Scene,
    framebuffer: torch.Tensor,  # (pixels, 3) — updated in place
    pass_seed: int,
    block_lo: int,  # first ray id of the block
    rays_per_pixel: int,
    block_rays: int,
    bounces: int,
    sort_rays: bool,
    reparam: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Trace rays [block_lo, block_lo + block_rays) and add their radiance
    into the framebuffer rows they cover (blocks are whole-pixel runs). On
    the wavefront path a forward trace starts from the camera kernel's
    packed rows (``packed.trace_camera``)."""
    block_pixels = block_rays // rays_per_pixel
    px_lo = block_lo // rays_per_pixel
    suspect = 0
    with recording.span("rt.block"):
        if shade.megakernel_eligible(scene, reparam):
            ray_id = block_lo + torch.arange(block_rays, dtype=torch.int32, device=scene.device)
            collected = shade.shade_trace(scene, ray_id, rays_per_pixel, pass_seed, bounces)
            with recording.span("rt.accumulate"):
                contribution = collected.reshape(block_pixels, rays_per_pixel, 3).sum(dim=1)
                framebuffer[px_lo:px_lo + block_pixels] += contribution
        else:
            state, suspect = packed.trace_camera(
                scene, block_lo, block_rays, rays_per_pixel, pass_seed, bounces, sort_rays,
                reparam=reparam
            )
            with recording.span("rt.accumulate"):
                contribution = wavefront.accumulate_radiance(
                    state, rays_per_pixel, block_pixels,
                    ordered=wavefront.wavefront_ordered(scene, block_rays, bounces, sort_rays),
                )
                # In place: where the JAX version donates the framebuffer
                # buffer to XLA between blocks, the port adds into the
                # block's rows directly.
                framebuffer[px_lo:px_lo + block_pixels] += contribution
    return framebuffer, suspect


def render_pass(
    scene: Scene,
    framebuffer: torch.Tensor,  # (pixels, 3) raw accumulated sums — in place
    pass_seed: int,  # the reference's `remaining_rays`
    rays_per_pixel: int,
    bounces: int,
    sort_rays: bool,
    reparam: bool = False,
    pixels: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, int]:
    """Trace one pass of ``rays_per_pixel`` samples for every pixel (or the
    pixels ``[lo, hi)`` of ``pixels``, a sharded rank's share) into the
    framebuffer: one block for the shade kernel, ≤ RAY_BLOCK-ray blocks of
    whole pixels otherwise, counted from the first pixel traced, with the
    pass's packet backend (``_regime_scene``). Returns (framebuffer,
    suspect)."""
    total = framebuffer.shape[0] * rays_per_pixel
    if total >= 1 << 31:
        raise ValueError(f"{total} rays in one pass exceed the int32 ray ids")
    scene = _regime_scene(scene, rays_per_pixel)
    px_lo, px_hi = pixels if pixels is not None else (0, framebuffer.shape[0])
    first, end = px_lo * rays_per_pixel, px_hi * rays_per_pixel
    if shade.megakernel_eligible(scene, reparam):
        block = max(1, end - first)
    else:
        block = max(rays_per_pixel, (RAY_BLOCK // rays_per_pixel) * rays_per_pixel)
    suspect = 0
    with recording.span("rt.pass"):
        for lo in range(first, end, block):
            framebuffer, s = _render_block(
                scene, framebuffer, pass_seed, lo, rays_per_pixel,
                min(block, end - lo), bounces, sort_rays, reparam,
            )
            suspect += s
    return framebuffer, suspect


def render_framebuffer(
    scene: Scene,
    progress: Optional[Callable[[int, int], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    metrics=None,
    auto_retry: bool = True,
) -> torch.Tensor:
    """Full multi-pass render → raw accumulated (pixels, 3) framebuffer on
    the scene's device.

    With ``checkpoint_path``, resumes from a checkpoint of the same scene and
    persists at every ``checkpoint_every``-th pass boundary and after the
    last pass; pass seeds derive from the remaining-sample count, so a
    resumed render is bit-identical to an uninterrupted one. ``metrics``
    (``utils.metrics.Metrics``) records ``samples_done`` after every pass
    and ``suspect_rays`` at the end, and is attached for the loops' spans
    and counters (``utils/metrics``); ``progress(done, total)`` is called
    after every pass, once the device has finished it.

    If the closest-hit exactness certificate fires, the render is redone
    rather than shipping a possibly wrong image: first without a static
    ``live_schedule`` (a stale schedule reports unprocessed live rays
    through the certificate), then with a doubled ``packet_cap`` up to the
    cluster count (the xla engine's per-tile budget; the kernels are exact
    by construction). ``auto_retry=False`` raises instead."""
    with recording.attached(metrics):
        return _render_framebuffer(scene, progress, checkpoint_path, checkpoint_every, metrics,
                                   auto_retry)


def _render_framebuffer(scene, progress, checkpoint_path, checkpoint_every, metrics,
                        auto_retry) -> torch.Tensor:
    cfg = scene.config
    framebuffer = torch.zeros((scene.num_pixels, 3), dtype=torch.float32, device=scene.device)
    remaining = cfg.rays_per_pixel
    suspects = 0
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = ckpt.scene_fingerprint(scene)
        restored = ckpt.load_checkpoint(checkpoint_path, fingerprint)
        if restored is not None:
            fb_np, samples_done, suspects_done = restored
            framebuffer = torch.from_numpy(fb_np).to(scene.device)
            remaining = cfg.rays_per_pixel - samples_done
            # Re-enforce the certificate over the passes not re-run: resuming
            # a render whose earlier passes overflowed must not launder the
            # suspect count to zero.
            suspects = suspects_done
    passes_done = 0
    while remaining:
        chunk = min(remaining, cfg.max_rays_per_pixel_per_pass)
        remaining -= chunk
        framebuffer, suspect = render_pass(
            scene, framebuffer, remaining,
            rays_per_pixel=chunk, bounces=cfg.bounces, sort_rays=cfg.sort_rays,
        )
        suspects = suspects + suspect
        passes_done += 1
        done = cfg.rays_per_pixel - remaining
        if checkpoint_path is not None and (passes_done % checkpoint_every == 0
                                            or not remaining):
            recording.count("sync.host", 1)  # the framebuffer's copy to the host
            ckpt.save_checkpoint(checkpoint_path, framebuffer.cpu().numpy(), done,
                                 fingerprint, suspects=int(suspects))
        if metrics is not None:
            metrics.record("samples_done", done)
        if progress is not None:
            if framebuffer.device.type == "cuda":
                torch.cuda.synchronize(framebuffer.device)
            progress(done, cfg.rays_per_pixel)
    if isinstance(suspects, torch.Tensor):
        recording.count("sync.host", 1)
    suspects = int(suspects)  # one device sync, after the pass loop
    if metrics is not None:
        metrics.record("suspect_rays", suspects)
    if not suspects:
        return framebuffer
    retry = dict(progress=progress, checkpoint_path=checkpoint_path,
                 checkpoint_every=checkpoint_every, metrics=metrics, auto_retry=auto_retry)
    if auto_retry and cfg.live_schedule:
        warnings.warn(
            f"closest-hit certificate flagged {suspects} suspect ray-bounces with a "
            "static live_schedule set; re-rendering with the dynamic live prefix"
        )
        return render_framebuffer(scene.with_config(live_schedule=()), **retry)
    if auto_retry and cfg.packet_cap < scene.num_clusters:
        new_cap = min(max(cfg.packet_cap * 2, 8), scene.num_clusters)
        warnings.warn(
            f"closest-hit certificate flagged {suspects} suspect ray-bounces; "
            f"re-rendering with packet_cap {cfg.packet_cap} → {new_cap}"
        )
        return render_framebuffer(scene.with_config(packet_cap=new_cap), **retry)
    raise RuntimeError(
        f"closest-hit exactness certificate failed: {suspects} suspect ray-bounces "
        "(packet pair-budget overflow); raise RenderConfig.packet_cap"
    )


def render_image(
    scene: Scene, apply_bloom: bool = True, framebuffer: torch.Tensor = None
) -> np.ndarray:
    """Render to an (H, W, 3) uint8 image: pass loop → optional bloom on the
    raw sums → exposure/tonemap/sRGB."""
    cfg = scene.config
    if framebuffer is None:
        framebuffer = render_framebuffer(scene)
    with recording.span("rt.post"):
        image = framebuffer.reshape(cfg.height, cfg.width, 3)
        if apply_bloom:
            image = bloom_ops.apply_bloom(image, cfg.rays_per_pixel)
        display = tonemap_ops.tonemap(image, cfg.exposure, cfg.rays_per_pixel)
        return tonemap_ops.to_bytes(display).cpu().numpy()


def render_timed(scene: Scene) -> tuple:
    """Render with the reference's timing scope (the trace phase only,
    ending when the device has finished). Returns (uint8 image, seconds)."""
    start = time.perf_counter()
    framebuffer = render_framebuffer(scene)
    if framebuffer.device.type == "cuda":
        torch.cuda.synchronize(framebuffer.device)
    elapsed = time.perf_counter() - start
    return render_image(scene, framebuffer=framebuffer), elapsed
