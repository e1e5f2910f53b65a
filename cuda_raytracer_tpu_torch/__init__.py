"""cuda_raytracer_tpu_torch — the PyTorch / CUDA port of cuda_raytracer_tpu.

A second package beside the JAX one, laid out the same way so each module
has an obvious counterpart:

  models/  scene data model (dataclasses of tensors), scene DSL parser,
           PLY / PFM loaders, BVH builder and cluster cut
  ops/     vector math, bit-exact PCG RNG, camera rays, intersection,
           environment lookup, tonemap, bloom
  ops/kernels/  wrappers of the hand-written CUDA kernels (sources in csrc/)
  native/  the C++ BVH builder, compiled with g++ at first use
  render/  wavefront path tracer (the plain PyTorch path) and the pass loop
  utils/   device selection, PNG writer, checkpoint / resume, metrics
  cli.py   the command-line renderer (``python -m cuda_raytracer_tpu_torch``)

It imports ``torch`` and never ``jax`` or the JAX package. Entry points take
an explicit ``device``; the default is CUDA, and without a GPU they raise
rather than render on the CPU.
"""

__version__ = "0.1.0"

from cuda_raytracer_tpu_torch.models.scene import Materials, RenderConfig, Scene  # noqa: F401
from cuda_raytracer_tpu_torch.models.scene_dsl import load_scene  # noqa: F401
from cuda_raytracer_tpu_torch.utils.backend import default_device  # noqa: F401
