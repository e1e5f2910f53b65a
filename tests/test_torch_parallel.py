"""Sharded rendering and training of the port (``parallel/``) against the JAX package and the port's single-device paths.

The port's ranks are CPU processes joined by gloo (``torch_parallel_worker``,
2 and 4 ranks, each spawn joined within 120 s); the JAX package shards the
same scene over a JAX mesh of as many of the suite's 8 CPU devices.
Tolerances:

- sharded framebuffers within rtol 1e-5 / atol 1e-4 of JAX's sharded ones
  and of the port's single-device ones (a 9×9 × 1 spp case does not split
  evenly). Shares are cut at whole pixels and the other ranks add zeros, so
  against the port's single-device render they are in fact BIT-EQUAL, the
  packed torus's included, and the same bits on every rank;
- sharded gradients (``sharded_loss``, the all-reduce's backward the
  identity, then a sum of the ranks' gradients) within rtol 1e-4 / atol
  1e-5 of JAX's ``jax.grad(shard.sharded_loss)`` and of the port's
  single-device ``diff.render_and_grad``; the loss the same bits on every
  rank;
- a 10-step sharded Adam run: the loss falls, the same bits on both ranks;
- a size-1 mesh (no process group): ``render_framebuffer``'s bits, and
  ``diff.render_and_grad``'s loss and gradients;
- ``cli.main`` with ``cpu no_gpu --mesh 2`` writes the single-device CLI's
  PNG byte for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cuda_raytracer_tpu.parallel import mesh as jmesh
from cuda_raytracer_tpu.parallel import shard as jshard

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.parallel import mesh as mesh_mod
from cuda_raytracer_tpu_torch.parallel import shard
from cuda_raytracer_tpu_torch.render import diff, pipeline
from cuda_raytracer_tpu_torch.utils.png import read_png

import torch_parallel_worker as worker
from test_torch_diff import _jax_params
from test_torch_scene import build_both

REPO = Path(__file__).resolve().parents[1]
SIZES = (2, 4)
FB_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(seed=0, rpp=2, bounces=2)
TRAIN_STEPS = 10
# Job indices in the ranks' result lists.
RENDER_CORNELL, RENDER_ODD, RENDER_TORUS, RENDER_PACKED, GRADS, TRAIN, SCALING = range(7)


@pytest.fixture(scope="module")
def target():
    return worker.target_for(worker.build_scene("cornell", worker.CORNELL))


@pytest.fixture(scope="module")
def ranks(target, tmp_path_factory):
    """{size: [each rank's job results]} on 2 and 4 gloo ranks."""
    out = {}
    for size in SIZES:
        jobs = [("render", dict(scene="cornell", overrides=worker.CORNELL)),
                ("render", dict(scene="cornell", overrides=worker.ODD)),
                ("render", dict(scene="torus", overrides=worker.TORUS)),
                ("render", dict(scene="torus_packed", overrides=worker.TORUS)),
                ("grads", dict(scene="cornell", overrides=worker.CORNELL, target=target,
                               **GRAD))]
        if size == 2:
            jobs += [("train", dict(scene="cornell", overrides=worker.CORNELL, target=target,
                                    steps=TRAIN_STEPS, lr=2e-2)),
                     ("scaling", dict(scene="cornell", overrides=worker.CORNELL))]
        out[size] = worker.spawn(jobs, size, tmp_path_factory.mktemp(f"ranks{size}"))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("job,overrides", [(RENDER_CORNELL, worker.CORNELL),
                                           (RENDER_ODD, worker.ODD)])
def test_sharded_render_matches_jax_and_single_device(ranks, size, job, overrides):
    js, ts = build_both(builtin_scenes.CORNELL, overrides)
    ref = np.asarray(jshard.render_framebuffer_sharded(js, jmesh.make_mesh(jax.devices()[:size])))
    single = pipeline.render_framebuffer(ts).numpy()
    for results in ranks[size]:
        fb = results[job]
        np.testing.assert_allclose(fb, ref, **FB_TOL)
        np.testing.assert_allclose(fb, single, **FB_TOL)
        assert np.array_equal(fb, single)
    assert single.sum() > 0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("job", [RENDER_TORUS, RENDER_PACKED])
def test_sharded_mesh_render_bit_equal_single_device(ranks, size, job):
    """The small torus through the packet engine, unpacked and with
    ``cluster_pack=2``: the sharded framebuffer equals the unpacked
    single-device one."""
    single = pipeline.render_framebuffer(worker.build_scene("torus", worker.TORUS)).numpy()
    for results in ranks[size]:
        assert np.array_equal(results[job], single)
    assert single.sum() > 0


def _single_device_grads(target):
    ts = worker.build_scene("cornell", worker.CORNELL)
    loss, g = diff.render_and_grad(ts, target=torch.from_numpy(target),
                                   pass_seed=GRAD["seed"], rays_per_pixel=GRAD["rpp"],
                                   bounces=GRAD["bounces"])
    return float(loss), diff.params_to_numpy(g)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_gradients_match_single_device(ranks, target, size):
    loss, single = _single_device_grads(target)
    assert {results[GRADS][0] for results in ranks[size]} == {loss}  # the same bits
    for results in ranks[size]:
        for name, got in results[GRADS][1].items():
            np.testing.assert_allclose(got, single[name], **GRAD_TOL, err_msg=name)
    assert np.abs(single["materials.diffuse_albedo"]).max() > 0


def test_sharded_gradients_match_jax(ranks, target):
    """Against ``jax.grad(shard.sharded_loss)`` on a 2-device JAX mesh (one
    size: XLA takes minutes to compile the sharded gradient)."""
    js, ts = build_both(builtin_scenes.CORNELL, worker.CORNELL)
    start = diff.params_to_numpy(diff.split_params(ts)[0])
    j_grad = jax.grad(jshard.sharded_loss)(
        _jax_params(js, start), js, jmesh.make_mesh(jax.devices()[:2]),
        jnp.asarray(target), GRAD["rpp"], jnp.uint32(GRAD["seed"]), GRAD["bounces"])
    names = [f"materials.{f}" for f in diff.MATERIAL_FIELDS] + ["environment_map"]
    leaves = [getattr(j_grad.materials, f) for f in diff.MATERIAL_FIELDS]
    ref = dict(zip(names, [np.asarray(g) for g in leaves + [j_grad.environment_map]]))
    for results in ranks[2]:
        for name, got in results[GRADS][1].items():
            np.testing.assert_allclose(got, ref[name], **GRAD_TOL, err_msg=name)


def test_sharded_train_step_learns(ranks, target):
    (losses0, params0), (losses1, params1) = (r[TRAIN] for r in ranks[2])
    assert losses0 == losses1 and len(losses0) == TRAIN_STEPS
    assert losses0[-1] < losses0[0] and np.isfinite(losses0).all()
    for name in params0:
        assert np.array_equal(params0[name], params1[name]), name  # the same step everywhere
    # The first step's loss is the single-device loss at the start parameters.
    ts = worker.build_scene("cornell", worker.CORNELL)
    start = diff.params_to_numpy(diff.split_params(ts)[0])
    start["materials.diffuse_albedo"] *= 0.5
    first = diff.loss_against_target(diff.params_from_numpy(start, "cpu"), ts,
                                     torch.from_numpy(target), 3, 2, 3)
    np.testing.assert_allclose(losses0[0], float(first), rtol=1e-5)


def test_scaling_report_runs(ranks):
    reports = [r[SCALING] for r in ranks[2]]
    assert reports[0] == reports[1]
    assert reports[0]["1dev"] > 0 and reports[0]["2dev"] > 0
    assert reports[0]["scaling_efficiency"] > 0


def test_size1_mesh_bit_identical_to_single_device(target):
    mesh = mesh_mod.make_mesh(["cpu"])
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_names) == (1, 0, None, ("rays",))
    for name, overrides in (("cornell", worker.CORNELL), ("torus_packed", worker.TORUS)):
        scene = worker.build_scene(name, overrides)
        assert torch.equal(shard.render_framebuffer_sharded(scene, mesh),
                           pipeline.render_framebuffer(scene))
    scene = worker.build_scene("cornell", worker.CORNELL)
    t = torch.from_numpy(target)
    loss, g = shard.sharded_loss_and_grad(scene, mesh, t, 0, 2, 3)
    ref_loss, ref_g = diff.render_and_grad(scene, target=t, pass_seed=0, rays_per_pixel=2,
                                           bounces=3)
    assert float(loss) == float(ref_loss)
    for a, b in zip(diff.param_leaves(g), diff.param_leaves(ref_g)):
        assert torch.equal(a, b)
    report = shard.scaling_report(scene, mesh, rays_per_pixel=2, repeats=1)
    assert report["1dev"] > 0 and report["scaling_efficiency"] == 1.0


def test_mesh_helpers():
    assert mesh_mod.RAY_AXIS == jmesh.RAY_AXIS == "rays"
    mesh_mod.initialize_distributed(None, 1, 0)  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="one device"):
        mesh_mod.make_mesh(["cpu", "cpu"])
    assert shard.pixel_share(81, mesh_mod.Mesh(None, 3, 4, torch.device("cpu"))) == (60, 81)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_mesh()  # the default device is the GPU


def test_cli_mesh_writes_the_single_device_png(tmp_path):
    """``cli.main`` with ``cpu no_gpu --mesh 2`` (in a child process, so a
    hang fails within 120 s)."""
    scene = tmp_path / "cornell.scene"
    scene.write_text(builtin_scenes.CORNELL)
    small = ["--width", "16", "--height", "16", "--spp", "2", "--bounces", "2"]
    mesh_png, single_png = tmp_path / "mesh.png", tmp_path / "single.png"
    code = ("import sys; from cuda_raytracer_tpu_torch import cli; "
            f"sys.exit(cli.main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(scene), "cpu", "no_gpu", *small, "--mesh", "2",
         "--metrics", "--out", str(mesh_png)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"render_sharded"' in proc.stderr and "paths/s" in proc.stderr
    from cuda_raytracer_tpu_torch import cli

    assert cli.main([str(scene), "cpu", "no_gpu", *small, "--out", str(single_png)]) == 0
    assert mesh_png.read_bytes() == single_png.read_bytes()
    assert read_png(str(mesh_png)).shape == (16, 16, 3)
