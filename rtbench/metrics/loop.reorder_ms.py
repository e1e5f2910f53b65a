"""loop.reorder_ms: device milliseconds an image spends sorting and moving
rows in the mesh loop, from the profiler's trace over whole images: the
sort keys (csrc/rays.cu's ray_keys_kernel and cullhit_keys_kernel), the
stable argsort (PyTorch's radix sort: CUB's DeviceRadixSort kernels and
radixSortKVInPlace), and the row move (csrc/rays.cu's reorder_rows_kernel,
or torch.index_select's vectorized_gather_kernel where the program has no
such kernel). Kernels are matched by name, so the argsort of the block's
unsort by ray id (render/wavefront._UnsortByRayId) counts too; its gather,
an index_elementwise_kernel, does not. A scene that reorders nothing (the
brute megakernel) launches none of them, and the metric is left out."""

import re

MOVES = "image_s"
KERNELS = re.compile(r"\b(ray_keys_kernel|cullhit_keys_kernel|radixSortKVInPlace|"
                     r"vectorized_gather_kernel|reorder_rows_kernel|DeviceRadixSort\w*Kernel)\b")


def read(trace):
    if trace.kind != "image" or trace.units == 0:
        return None
    spans = [(s, e) for name, s, e in trace.device_events if KERNELS.search(name)]
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace.units
