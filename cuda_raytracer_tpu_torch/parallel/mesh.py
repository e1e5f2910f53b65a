"""Process groups for ray-parallel rendering (counterpart of ``cuda_raytracer_tpu/parallel/mesh.py``).

The parallel axis of a path tracer is rays: every ray is independent until
the framebuffer sum. The JAX package shards the ray axis of one program over
a 1-D device mesh named ``"rays"``. Here each device is driven by a process
of its own (a rank of a ``torch.distributed`` group), every rank holds the
whole scene, and framebuffers and gradients are summed over the group with
``all_reduce``: NCCL between CUDA devices, gloo on the CPU.

A ``Mesh`` is that group as one rank sees it: the process group, the rank,
the group's size and the rank's ``torch.device``. ``make_mesh`` returns the
initialised group, or a size-1 mesh on the default device when there is
none. ``initialize_distributed`` joins a group as the JAX function does (it
does nothing for one process); ``init_group`` joins one of any size.

The JAX module's ``ray_sharding`` and ``replicated`` build ``NamedSharding``
placements for XLA. PyTorch places nothing across processes (each rank holds
its own tensors), so they have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from cuda_raytracer_tpu_torch.utils.backend import default_device, resolve_device

RAY_AXIS = "rays"

# This process's device, as given to init_group (None before it is called).
_RANK_DEVICE: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D group of ranks along ``RAY_AXIS``."""

    group: Optional[dist.ProcessGroup]  # None: a size-1 mesh with no group
    rank: int
    size: int
    device: torch.device
    axis_names: tuple = (RAY_AXIS,)

    def all_reduce(self, tensor: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``tensor`` over the group, in place; a mesh with no
        group leaves it as it is."""
        if self.group is not None:
            dist.all_reduce(tensor, op=op or dist.ReduceOp.SUM, group=self.group)
        return tensor


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The initialised group as a mesh, else a size-1 mesh with no group.
    ``devices`` names one device per rank; by default a rank runs on the
    device it joined the group with (``init_group``), else on the default
    device (CUDA)."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        if devices is not None and len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a group of {size} ranks")
        if devices is not None:
            device = torch.device(devices[rank])
        else:
            device = _RANK_DEVICE or default_device()
        return Mesh(dist.group.WORLD, rank, size, device)
    if devices is not None and len(devices) != 1:
        raise ValueError("without a process group a mesh has one device; "
                         "call init_group in each of the ranks' processes first")
    return Mesh(None, 0, 1, resolve_device(devices[0] if devices else None))


def init_group(coordinator_address: str, num_processes: int, process_id: int,
               device=None, backend: Optional[str] = None) -> Mesh:
    """Join the group of ``num_processes`` ranks as rank ``process_id``,
    running on ``device`` (default CUDA), and return its mesh. The
    coordinator is ``host:port`` (or a ``tcp://`` URL) that rank 0 listens
    on. The backend is NCCL for a CUDA device and gloo on the CPU unless
    ``backend`` names one (gloo also sums CUDA tensors, through the host,
    which lets several ranks share one card)."""
    global _RANK_DEVICE
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    _RANK_DEVICE = device
    mesh = make_mesh()
    # One collective now, so the backend's lazy set-up (NCCL's communicator)
    # happens at join time and not inside the first render.
    mesh.all_reduce(torch.zeros(1, device=device))
    return mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Multi-process bring-up, as the JAX function: nothing for a
    single-process run; otherwise ``init_group`` on ``device``."""
    if num_processes is None or num_processes <= 1:
        return
    init_group(coordinator_address, num_processes, process_id, device, backend)


def shutdown() -> None:
    """Leave the group, if this process joined one."""
    global _RANK_DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None
