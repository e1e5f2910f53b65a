"""hit.sphere_roofline: the share of its roofline that the sphere-testing
kernels of ``hit.sphere_ms`` reach over the traced images: the least time
the card could take for the work the inputs need, the larger of its FP32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s (one H100 SXM,
NVIDIA's data sheet), over the time they took.

The work is counted from the program's records: the operations from
``hit.sphere_tests`` (the ray-sphere tests the closest hit needs, each
bounce's live rows against the scene's spheres), the bytes from
``rays.launched`` (the rows the set-up ran over, which it reads and writes
whether they are live or not), at today's set-up kernel's rates
(csrc/rays.cu:40-42): 21 FP32 operations a test (brute::sphere_t: the
offset's 3, the dot product's 5, the squared length less r²'s 7, the
discriminant's 2, a max and a square root, the two roots' 2), and a row's
48 bytes read (origin, direction, throughput) and 9 written (alive, t,
index). A scene without the packet engine has no ray tiles, so their 32
bytes are not written. Tests the kernel makes beyond those (dead rows,
padding rows) are time the share shows, not work it counts. A program
without the test counter gives nothing."""

from pathlib import Path

from rtbench.core import program
from rtbench.core.spec import load_module

MOVES = "image_s"
FLOPS_PER_TEST = 21
BYTES_PER_ROW = 48 + 9
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

_ms = load_module(Path(__file__).with_name("hit.sphere_ms.py"))


def read(trace):
    tests = program.per_unit(trace, "image", "counters", "hit.sphere_tests")
    rows = program.per_unit(trace, "image", "counters", "rays.launched")
    ms = _ms.read(trace)
    if not tests or rows is None or not ms:
        return None
    bound_s = max(tests * FLOPS_PER_TEST / PEAK_FLOPS, rows * BYTES_PER_ROW / PEAK_BYTES)
    return bound_s / (ms * 1e-3)
