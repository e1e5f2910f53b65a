"""Device selection for the PyTorch port.

Every entry point that creates tensors takes an explicit ``device``. Left
as ``None`` it means the GPU: the port renders on CUDA by default and never
falls back to the CPU on its own. A caller that wants the CPU (the tests, a
debugging session) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device, or a clear error when this machine has none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cuda_raytracer_tpu_torch renders on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else → ``torch.device``,
    checked to exist when it names CUDA."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
