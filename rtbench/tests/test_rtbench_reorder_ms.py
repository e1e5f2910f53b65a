"""The ``loop.reorder_ms`` reader (``rtbench/metrics/loop.reorder_ms.py``):
device milliseconds an image spends in the mesh loop's sort keys, argsort
and row moves, kernels matched by name.

It gives nothing for a train trace, for an image trace without device
events, or for one whose kernels are none of those (the brute megakernel's
images). Over a synthetic image trace it sums the named kernels' device time
per image, whatever their template arguments, and leaves the others out.
"""

from __future__ import annotations

import pytest

from rtbench.tests.test_rtbench_program_metrics import STAND_IN, UNITS, _reader, _trace

NAME = "loop.reorder_ms"

# (name as the profiler gives it, start µs, end µs)
REORDER = [
    ("void (anonymous namespace)::ray_keys_kernel(float const*, int, float const*, "
     "float const*, int, int, long long*, int*, unsigned int*)", 0.0, 10.0),
    ("void (anonymous namespace)::cullhit_keys_kernel<false>(float const*, int)", 10.0, 60.0),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::"
     "DeviceRadixSortPolicy<long, long, unsigned int>::Policy900, false>(int*)", 60.0, 160.0),
    ("void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<at_cuda_detail::cub::"
     "DeviceRadixSortPolicy<long, long, unsigned int>::Policy900, false>(long const*)",
     160.0, 166.0),
    ("void at::native::radixSortKVInPlace<-2, -1, 128, 32, long, long, unsigned int>(...)",
     166.0, 190.0),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int)",
     190.0, 284.0),
    ("void (anonymous namespace)::reorder_rows_kernel<long long>(uint4 const*, long long "
     "const*, int, int, uint4*)", 284.0, 300.0),
]
OTHERS = [
    ("void (anonymous namespace)::bvh_walk_kernel(float const*)", 300.0, 700.0),
    ("void (anonymous namespace)::bounce_rows_kernel<true>(float*)", 700.0, 720.0),
    ("void (anonymous namespace)::rays_setup_kernel(float const*)", 720.0, 730.0),
    ("void (anonymous namespace)::camera_rows_kernel(float const*)", 730.0, 737.0),
    ("Memcpy DtoH (Device -> Pinned)", 737.0, 738.0),
    ("void (anonymous namespace)::shade_kernel(float const*)", 738.0, 900.0),
]


def test_nothing_outside_image_traces():
    assert _reader(NAME).read(_trace("train", REORDER + OTHERS)) is None


@pytest.mark.parametrize("events", [[], STAND_IN, OTHERS])
def test_nothing_without_its_kernels(events):
    assert _reader(NAME).read(_trace("image", events)) is None


def test_sum_per_image():
    """300 µs of the named kernels over the trace's two images: 0.15 ms an
    image, the walk, the bounce, the set-up, the camera, a copy and the
    brute megakernel left out."""
    got = _reader(NAME).read(_trace("image", OTHERS[:3] + REORDER + OTHERS[3:]))
    assert got == pytest.approx(300.0 * 1e-3 / UNITS)
    assert _reader(NAME).read(_trace("image", REORDER[-1:])) == pytest.approx(16e-3 / UNITS)
