"""Command-line driver (counterpart of ``cuda_raytracer_tpu/cli.py``; reference: main, raytracing.cu:305-398).

Usage mirrors the reference::

    python -m cuda_raytracer_tpu_torch <scene.scene> [no_sort] [cpu] [no_gpu] [no_bvh]

with the same order-insensitive positional flags and exit codes (usage → 1,
unknown flag → 1, no backend → 2). The accelerator render runs on the CUDA
device through the hand-written kernels, and raises when there is none;
``cpu`` is the caller asking for the CPU: the same scene rendered with
``device="cpu"`` through the kernels' plain PyTorch versions, the
dual-backend cross-check the reference used for validation. When both run,
the images go to ``<out>`` and ``<out>.cpu.png`` (and the CPU run's
checkpoint to ``<checkpoint>.cpu.npz``); both get the same post chain
(``--no-bloom`` skips bloom on both). The GNU options expose what the
reference configured by editing the scene file: resolution, samples,
bounces, checkpointing, metrics and the packet intersector's knobs.

``--mesh N`` shares the rays of every pass among N ranks
(``parallel/shard.py``). One device renders in this process, as in the JAX
CLI; N > 1 starts one process per device with ``torch.multiprocessing``:
N CUDA devices joined by NCCL, or, with ``cpu no_gpu``, N ranks on the CPU
joined by gloo. Rank 0 writes the PNG and the metrics line (phase
``render_sharded``); as in the JAX CLI the sharded render takes no
checkpoint and runs no second backend.
"""

from __future__ import annotations

import argparse
import sys

import torch

FLAGS = ("no_sort", "cpu", "no_gpu", "no_bvh")
PACKET_OPTIONS = ("packet_skip", "packet_tile", "cluster_tris", "cull_split", "cull_hier")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cuda_raytracer_tpu_torch",
        description="Monte-Carlo path tracer on a CUDA GPU (PyTorch port)",
    )
    parser.add_argument("scene", help="scene description file (.scene DSL)")
    parser.add_argument("flags", nargs="*",
                        help="reference-compatible flags: " + " ".join(FLAGS) + " (no_sort: "
                        "no reorder between bounces; the BVH walk on a CUDA device never "
                        "reorders, so it matters only to the packet engines and the CPU)")
    parser.add_argument("--out", default="raytracing.png", help="output PNG path")
    parser.add_argument("--width", type=int, help="override image width")
    parser.add_argument("--height", type=int, help="override image height")
    parser.add_argument("--spp", type=int, help="override rays per pixel")
    parser.add_argument("--bounces", type=int, help="override bounce limit")
    parser.add_argument("--no-bloom", action="store_true", help="skip bloom post-pass")
    parser.add_argument("--checkpoint", help="checkpoint file for resumable accumulation")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="passes between checkpoints")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard rays over N devices, one process each (0 = "
                        "single-device render; with 'cpu no_gpu': N CPU ranks)")
    parser.add_argument("--metrics", action="store_true",
                        help="emit a JSON metrics line to stderr: phases (the render "
                             "loops' rt.* spans among them, rt.tail too), counters "
                             "(sync.host, bounces.sorted, rays.live, rays.live_tail, "
                             "rays.launched, hit.sphere_tests, shade.dielectric, "
                             "shade.emissive, sync.device_idle_s, bounces.packed, "
                             "bounces.graphed, graph.captures, reorder.rows and the kernel "
                             "launches) and series")
    # The packet intersector's knobs. A mesh on a CUDA device walks the BVH
    # instead (wavefront.resolve_intersector), and there they do nothing.
    parser.add_argument("--packet-skip", action="store_true",
                        help="packet intersector: enable the fused kernel's per-ray "
                        "slab-entry early-out (exact)")
    parser.add_argument("--packet-tile", type=int,
                        help="packet intersector: rays per packet tile (default 64)")
    parser.add_argument("--cluster-tris", type=int,
                        help="packet intersector: triangles per cluster block "
                        "(multiple of 128; default 256)")
    parser.add_argument("--cull-split", type=int,
                        help="packet intersector: tight sub-AABBs per cluster block in "
                        "the cull (must divide cluster-tris; default 1)")
    parser.add_argument("--cull-hier", type=int,
                        help="packet intersector: hierarchical cull, clusters per "
                        "super-AABB gating 128-box chunks of the main cull (cull-hier * "
                        "cull-split must divide 128; 0 = flat cull, the default)")
    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: cuda_raytracer_tpu_torch <scene>", file=sys.stderr)
        return 1
    args = build_parser().parse_args(argv)

    unknown = set(args.flags) - set(FLAGS)
    if unknown:
        print(f"Unknown flags: {sorted(unknown)}", file=sys.stderr)
        return 1
    sort_rays = "no_sort" not in args.flags
    run_cpu = "cpu" in args.flags
    run_accel = "no_gpu" not in args.flags
    use_bvh = "no_bvh" not in args.flags
    if not run_cpu and not run_accel:
        print("No raytracing hardware specified", file=sys.stderr)
        return 2

    from cuda_raytracer_tpu_torch.models import cluster as cluster_mod
    from cuda_raytracer_tpu_torch.models.scene_dsl import load_scene
    from cuda_raytracer_tpu_torch.ops.kernels.counts import launch_counts, launches_since
    from cuda_raytracer_tpu_torch.render import pipeline
    from cuda_raytracer_tpu_torch.utils.backend import default_device
    from cuda_raytracer_tpu_torch.utils.metrics import Metrics, attached
    from cuda_raytracer_tpu_torch.utils.png import write_png

    metrics = Metrics()
    overrides = dict(sort_rays=sort_rays)
    if args.packet_skip:
        overrides["packet_skip"] = True
    for key, value in (
        ("packet_tile", args.packet_tile),
        ("cull_split", args.cull_split),
        ("cull_hier", args.cull_hier),
        ("width", args.width),
        ("height", args.height),
        ("rays_per_pixel", args.spp),
        ("bounces", args.bounces),
    ):
        if value is not None:
            overrides[key] = value
    load_kwargs = dict(use_bvh=use_bvh, config_overrides=overrides,
                       cluster_tris=args.cluster_tris or cluster_mod.DEFAULT_CLUSTER_TRIS)

    if args.mesh:
        return _run_mesh(args, load_kwargs, "cuda" if run_accel else "cpu")

    # The accelerator run needs the GPU (and raises without one); a CPU-only
    # run never touches CUDA.
    device = default_device() if run_accel else torch.device("cpu")
    with metrics.phase("load_scene"):
        scene = load_scene(args.scene, device=device, **load_kwargs)
    print(
        f"Scene: {scene.sphere_count} spheres, {scene.triangle_count} triangles, "
        f"{scene.bvh_node_count} BVH nodes",
        file=sys.stderr,
    )
    _warn_unused_packet_options(args, scene)

    def run_backend(scene, label: str, checkpoint_path):
        before = launch_counts()
        with metrics.phase(f"render_{label}"):
            framebuffer = pipeline.render_framebuffer(
                scene, checkpoint_path=checkpoint_path,
                checkpoint_every=args.checkpoint_every, metrics=metrics,
            )
            if framebuffer.device.type == "cuda":
                torch.cuda.synchronize(framebuffer.device)
        for name, n in launches_since(before).items():
            metrics.count(f"launches_{name}", n)
        with metrics.phase(f"post_{label}"), attached(metrics):
            image = pipeline.render_image(scene, apply_bloom=not args.no_bloom,
                                          framebuffer=framebuffer)
        rate = metrics.throughput(
            f"paths_per_s_{label}", scene.num_pixels * scene.config.rays_per_pixel,
            f"render_{label}",
        )
        print(f"{label} took {metrics.phases[f'render_{label}']:.2f}s"
              + (f" ({rate:.3e} paths/s)" if rate else ""), file=sys.stderr)
        return image

    if run_accel:
        write_png(args.out, run_backend(scene, "accelerator", args.checkpoint))
    if run_cpu:
        # Beside an accelerator run the CPU run keeps its own checkpoint: the
        # two scenes share a fingerprint, and resuming from the other run's
        # finished file would skip the cross-check.
        checkpoint = args.checkpoint
        if run_accel and checkpoint is not None:
            checkpoint += ".cpu.npz"
        image = run_backend(scene.to("cpu"), "cpu", checkpoint)
        write_png(args.out + ".cpu.png" if run_accel else args.out, image)

    if args.metrics:
        metrics.emit(stream=sys.stderr, scene=args.scene)
    print(f"Wrote {args.out}", file=sys.stderr)
    return 0


def _warn_unused_packet_options(args, scene) -> None:
    """Name on stderr the packet intersector's options that were given for
    a scene that resolves to another intersector, where they do nothing."""
    from cuda_raytracer_tpu_torch.render.wavefront import resolved_intersector

    given = [f"--{name.replace('_', '-')}" for name in PACKET_OPTIONS
             if getattr(args, name) not in (None, False)]
    resolved = resolved_intersector(scene)
    if given and resolved != "packet":
        print(f"Warning: {' '.join(given)} apply to the packet intersector; this scene "
              f"resolves to '{resolved}' on {scene.device.type}, so they have no effect",
              file=sys.stderr)


def _run_mesh(args, load_kwargs: dict, device_type: str) -> int:
    """``--mesh N``. One device renders in this process, on a size-1 mesh
    (``parallel.mesh.make_mesh``), as the JAX CLI does; N > 1 spawns N
    ranks, one process per device, each running
    ``parallel.shard.cli_worker``; a failed rank raises here."""
    import socket

    import torch.multiprocessing as mp

    from cuda_raytracer_tpu_torch.parallel import shard
    from cuda_raytracer_tpu_torch.parallel.mesh import make_mesh
    from cuda_raytracer_tpu_torch.utils.backend import default_device

    if device_type == "cuda":
        default_device()  # raises without CUDA
        if torch.cuda.device_count() < args.mesh:
            raise RuntimeError(f"--mesh {args.mesh} needs {args.mesh} CUDA devices, "
                               f"this machine has {torch.cuda.device_count()}")
    render_args = (args.scene, load_kwargs, args.out, not args.no_bloom,
                   args.scene if args.metrics else None)
    if args.mesh == 1:
        shard.cli_render(make_mesh([device_type]), *render_args)
    else:
        with socket.socket() as s:  # a free port for rank 0 to listen on
            s.bind(("localhost", 0))
            coordinator = f"localhost:{s.getsockname()[1]}"
        mp.start_processes(shard.cli_worker, nprocs=args.mesh, join=True,
                           start_method="spawn",
                           args=(coordinator, args.mesh, device_type, *render_args))
    print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
