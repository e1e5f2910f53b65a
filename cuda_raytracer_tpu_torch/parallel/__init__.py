"""Ray-parallel rendering and training over ``torch.distributed`` (counterpart of ``cuda_raytracer_tpu/parallel/``).

One process per device, the scene replicated in each, framebuffers and
gradients summed over the group.
"""
