"""The kernel build's cache key covers every local header a source includes."""

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.ops.kernels import build


def test_digest_follows_included_headers(tmp_path):
    (tmp_path / "inner.cuh").write_text("// inner v1\n")
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    source = tmp_path / "k.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n// kernel\n')
    first = build.source_digest(source)
    assert build.source_digest(source) == first
    (tmp_path / "inner.cuh").write_text("// inner v2\n")  # a header two levels down
    second = build.source_digest(source)
    assert second != first
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edit\n')
    assert build.source_digest(source) not in (first, second)

