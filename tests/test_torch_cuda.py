"""The CUDA shade kernel on the GPU, against its plain PyTorch version.

The kernel's output must not depend on its grid (persistent blocks, path
regeneration), and the wavefront's one-hot material lookup must give the
gather's bits with TF32 allowed.

Marked ``cuda``: skipped on a machine without a GPU. On the GPU machine,
which has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes, scene_dsl
from cuda_raytracer_tpu_torch.ops.kernels import shade
from cuda_raytracer_tpu_torch.render import pipeline, wavefront

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _scene(name, device, **overrides):
    parsed = scene_dsl.parse_scene_text(builtin_scenes.SCENES[name])
    return scene_dsl.assemble_scene(
        parsed, config_overrides=dict(width=32, height=32, **overrides), device=device
    )


def _agree(a, b):
    diff = (a - b).abs().amax(dim=1)
    return float((diff < 1e-3).float().mean())


@pytest.mark.parametrize("name", sorted(builtin_scenes.SCENES))
def test_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    for lo, n in ((0, 32 * 32 * 4), (100, 260)):
        ids = lo + torch.arange(n, dtype=torch.int32, device=cuda)
        before = shade.LAUNCHES
        got = shade.shade_trace(scene, ids, 4, 5, 10)
        assert shade.LAUNCHES == before + 1
        ref = shade.plain_trace(scene, ids, 4, 5, 10)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _agree(got, ref) >= 0.999


def test_pipeline_uses_kernel_and_matches_plain(cuda):
    scene = _scene("cornell_plus", cuda, rays_per_pixel=5, bounces=4,
                   max_rays_per_pixel_per_pass=2)
    assert shade.megakernel_eligible(scene)
    before = shade.LAUNCHES
    fb = pipeline.render_framebuffer(scene)
    assert shade.LAUNCHES == before + 3  # passes of 2 + 2 + 1 rays per pixel
    plain = pipeline.render_framebuffer(scene.with_config(shade_engine="xla"))
    assert shade.LAUNCHES == before + 3
    close = torch.isclose(fb, plain, rtol=1e-4, atol=0).all(dim=1)
    assert float(close.float().mean()) >= 0.99


def test_kernel_rejects_mixed_devices(cuda):
    scene = _scene("spheres", cuda)
    with pytest.raises(ValueError, match="scene on"):
        shade.shade_trace(scene, torch.arange(8, dtype=torch.int32), 2, 0, 3)


@pytest.mark.parametrize("name", ["cornell_plus", "spheres"])
def test_kernel_bits_independent_of_grid(cuda, name):
    """The persistent grid, one block per SM and a single block: the same
    bits (each path's radiance depends on its ray id alone)."""
    scene = _scene(name, cuda)
    ids = torch.arange(32 * 32 * 8, dtype=torch.int32, device=cuda)
    per_sm, sms = shade.persistent_grid(scene)
    assert per_sm >= 1 and sms >= 1
    got = shade.shade_trace(scene, ids, 8, 2, 10)
    for blocks in (sms, 1):
        other = shade.trace_on_grid(scene, ids, 8, 2, 10, blocks)
        assert torch.equal(other, got), blocks
    torch.cuda.synchronize()


def test_material_lookup_exact_under_tf32(cuda):
    """The one-hot product reproduces the gathered rows bit for bit even
    with TF32 matmuls allowed."""
    scene = _scene("cornell_plus", cuda)
    mats = scene.materials
    mat_i = torch.randint(0, mats.diffuse_albedo.shape[0], (4099,), device=cuda)
    gather = torch.cat([mats.diffuse_albedo[mat_i], mats.specular_albedo[mat_i],
                        mats.emitted[mat_i], mats.metallicity[mat_i, None],
                        mats.roughness[mat_i, None], mats.index_of_refraction[mat_i, None]], 1)
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rows = wavefront.material_rows(mats, mat_i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    assert torch.equal(rows, gather)
