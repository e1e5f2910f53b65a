"""Differentiable rendering of the port (render/diff.py, the wavefront's gradient cuts) against the JAX package.

The same scene text is assembled by both packages and the same parameters,
targets and optimiser state are handed to both as numpy arrays. Tolerances:

- per-ray state after a reparameterised bounce, and per-pixel radiance: the
  repo's agreement gate, max |Δ| < 1e-3 on >= 99.9 % of rays / pixels (libm
  sin/cos differ by ulps);
- recomputed hit distances: rtol 1e-4 (XLA's CPU backend contracts
  multiply-adds into FMAs, see test_torch_packet.py);
- every gradient leaf: |g - g_jax| <= 1e-3 · max|g_jax| + 1e-6 (the two
  packages sum the per-ray contributions in other orders);
- detached mode: roughness and ior gradients EXACTLY 0, metallicity non-zero;
- a few Adam steps: parameters within 1e-5 of optax's;
- the unsort's backward, checkpointed against stored bounces, the live
  schedule and the audit: EQUAL;
- the material lookup (a one-hot product, as in JAX): the gather's forward
  bits EXACTLY, its gradient within 1e-5 of the largest of the gather's
  (a float64 matmul against a float32 scatter-add: sum order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cuda_raytracer_tpu.render import diff as jdiff
from cuda_raytracer_tpu.render import wavefront as jwavefront

import torch_threads  # noqa: F401  (this process's share of the cores)

from cuda_raytracer_tpu_torch.models import builtin_scenes
from cuda_raytracer_tpu_torch.render import diff, packed, wavefront

from test_diff import CORNELL_MINI, GLASS_SPHERE, METAL_SPHERE, _smooth_env
from test_torch_packet import build_mesh_both
from test_torch_scene import build_both

# A half-metallic rough sphere beside a glass one: every shading branch,
# and a metallicity coin whose score-function gradient is non-zero.
METAL_GLASS = """
material metal diffuse 0.2 0.3 0.4 specular 0.9 0.8 0.7 metallicity 0.5 roughness 0.3
material glass ior 1.5
sphere metal -1.1 0 4 1
sphere glass 1.1 0 4 1
sky 0.3 0.5 0.8
camera position 0 0 -2 forward 0 0 1 up 0 1 0 fov 60
image 4 4 2 3 1
"""


def _with_env(js, ts, env):
    return (dataclasses.replace(js, environment_map=jnp.asarray(env)),
            ts.replace(environment_map=torch.from_numpy(env)))


def _brute(text, env=False):
    js, ts = build_both(text)
    return _with_env(js, ts, _smooth_env()) if env else (js, ts)


@pytest.fixture(scope="module")
def torus():
    """The small torus in clusters of 32 (K > ROUND1_NEAREST), 8x8 x 2 spp."""
    return build_mesh_both(builtin_scenes.torus(builtin_scenes.SMALL),
                           dict(width=8, height=8, rays_per_pixel=2, bounces=3),
                           cluster_tris=32, sky=True)


def _jax_params(js, arrays):
    params, _ = jdiff.split_params(js)
    mats = dataclasses.replace(params.materials, **{
        f: jnp.asarray(arrays[f"materials.{f}"]) for f in diff.MATERIAL_FIELDS})
    return params._replace(materials=mats,
                           environment_map=jnp.asarray(arrays["environment_map"]))


def _weights(pixels):
    """The weighted-sum loss of tests/test_diff.py (gradients vary across
    channels), its weights computed once by JAX for both packages."""
    return np.array(jnp.linspace(0.5, 1.5, pixels * 3).reshape(pixels, 3))


def _grads_both(js, ts, reparam, rpp, bounces, seed=0):
    w = _weights(ts.num_pixels)

    def jloss(p):
        return jnp.sum(jdiff.render_radiance(p, js, jnp.uint32(seed), rpp, bounces,
                                             reparam=reparam) * w)

    j_loss, j_grad = jax.value_and_grad(jloss)(jdiff.split_params(js)[0])
    wt = torch.from_numpy(w)
    t_loss, t_grad = diff.render_and_grad(ts, loss_fn=lambda r: (r * wt).sum(),
                                          pass_seed=seed, rays_per_pixel=rpp,
                                          bounces=bounces, reparam=reparam)
    names = [f"materials.{f}" for f in diff.MATERIAL_FIELDS] + ["environment_map"]
    j_leaves = [getattr(j_grad.materials, f) for f in diff.MATERIAL_FIELDS]
    return (float(j_loss), float(t_loss),
            {n: (np.asarray(j), g.numpy()) for n, j, g in
             zip(names, j_leaves + [j_grad.environment_map], diff.param_leaves(t_grad))})


def _assert_grads_close(grads):
    for name, (ref, got) in grads.items():
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        tol = 1e-3 * float(np.abs(ref).max()) + 1e-6
        assert float(np.abs(got - ref).max()) <= tol, (name, np.abs(got - ref).max(), tol)


def _rays(ts, n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 2.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("scene", ["metal_glass", "torus"])
def test_recompute_hit_distance_matches_jax(torus, scene):
    js, ts = torus if scene == "torus" else _brute(METAL_GLASS)
    o, d = _rays(ts, 512, seed=1)
    if scene == "torus":
        o = o + np.float32([0.0, 1.5, -1.0])
    t, index, _ = wavefront.closest_hit(ts, torch.from_numpy(o), torch.from_numpy(d))
    assert (index >= 0).sum() > 100 and (index < 0).any()
    got = wavefront.recompute_hit_distance(ts, torch.from_numpy(o), torch.from_numpy(d),
                                           index, t)
    ref = jwavefront.recompute_hit_distance(js, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(index.numpy()), jnp.asarray(t.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    hit = (index >= 0).numpy()
    np.testing.assert_allclose(got.numpy()[hit], t.numpy()[hit], rtol=1e-4)
    assert bool((got[index < 0] == 0).all())  # no 1e30 enters the graph


@pytest.mark.parametrize("scene", ["metal_glass", "torus"])
def test_process_rays_reparam_matches_jax(torus, scene):
    """Two reparameterised bounces: every leaf of the state within the
    agreement gate."""
    js, ts = torus if scene == "torus" else _brute(METAL_GLASS, env=True)
    rays = ts.num_pixels * 2
    ids = np.arange(rays, dtype=np.int32)
    jstate = jwavefront.make_initial_state(js, jnp.asarray(ids), 2, 5)
    tstate = wavefront.make_initial_state(ts, torch.from_numpy(ids), 2, 5)
    for bounce in range(2):
        jstate, _ = jwavefront.process_rays(js, jstate, jnp.uint32(5), bounce, reparam=True)
        tstate, _ = wavefront.process_rays(ts, tstate, 5, bounce, reparam=True)
        for ref, got in zip(jstate[:4], tstate[:4]):
            ref, got = np.asarray(ref), got.detach().numpy()
            assert np.isfinite(got).all()
            agree = (np.abs(got - ref).max(axis=1) < 1e-3).mean()
            assert agree >= 0.999, (bounce, agree)


@pytest.mark.parametrize("scene", ["cornell_mini", "torus"])
def test_render_radiance_matches_jax(torus, scene):
    js, ts = torus if scene == "torus" else _brute(CORNELL_MINI)
    jp, _ = jdiff.split_params(js)
    ref = np.asarray(jdiff.render_radiance(jp, js, jnp.uint32(3), 2, 3))
    got = diff.render_radiance(diff.split_params(ts)[0], ts, 3, 2, 3)
    assert got.shape == (ts.num_pixels, 3)
    agree = (np.abs(got.numpy() - ref).max(axis=1) < 1e-3).mean()
    assert agree >= 0.999 and np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("text,env,reparam", [
    (CORNELL_MINI, False, False),
    (METAL_SPHERE, True, False),
    (METAL_SPHERE, True, True),
    (GLASS_SPHERE, True, True),
    (METAL_GLASS, True, False),
    (METAL_GLASS, True, True),
], ids=["cornell_mini", "metal", "metal-reparam", "glass-reparam", "metal_glass",
        "metal_glass-reparam"])
def test_render_and_grad_matches_jax(text, env, reparam):
    js, ts = _brute(text, env)
    j_loss, t_loss, grads = _grads_both(js, ts, reparam, rpp=2, bounces=3)
    assert abs(t_loss - j_loss) <= 1e-4 * abs(j_loss)
    _assert_grads_close(grads)
    if not reparam:  # detached: exactly zero, as a tensor
        for name in ("materials.roughness", "materials.index_of_refraction"):
            assert not grads[name][1].any(), name
    if text is METAL_GLASS:
        # The score-function term: metallicity of the half-metal sphere.
        assert grads["materials.metallicity"][1][0] != 0.0
    if reparam and text is not CORNELL_MINI:
        # Pathwise gradients exist only with reparam.
        assert grads["materials.roughness"][1].any() or grads[
            "materials.index_of_refraction"][1].any()


@pytest.mark.parametrize("backend,reparam", [("xla", False), ("pallas", False)])
def test_render_and_grad_torus_matches_jax(torus, backend, reparam):
    """The mesh path (packet intersector, Morton reorder, live prefix,
    unsort): the port's xla and pallas engines against JAX's xla engine
    (the engines are exact, so they give the same hits)."""
    js, ts = torus
    ts = ts.with_config(packet_backend=backend)
    j_loss, t_loss, grads = _grads_both(js, ts, reparam, rpp=2, bounces=3)
    assert abs(t_loss - j_loss) <= 1e-4 * abs(j_loss)
    _assert_grads_close(grads)
    if not reparam:
        assert not grads["materials.roughness"][1].any()
    assert grads["materials.metallicity"][1][0] != 0.0  # the torus is 0.3 metallic


def test_detached_trace_keeps_geometry_out_of_the_graph():
    """The repaired gradient cuts: in detached mode no ray origin or
    direction is in the graph after a trace, and the material leaves get
    gradients only where JAX gives them; with reparam the directions stay
    in the graph."""
    _, ts = _brute(METAL_GLASS, env=True)
    for reparam in (False, True):
        params = diff.make_leaves(diff.split_params(ts)[0])
        scene = diff.merge_params(ts, params)
        ids = torch.arange(32, dtype=torch.int32)
        state = wavefront.make_initial_state(scene, ids, 2, 0)
        state, _ = packed.trace_wavefront(scene, state, 0, 3, False, reparam=reparam)
        assert state.origin.requires_grad == reparam
        assert state.direction.requires_grad == reparam
        state.collected.sum().backward()
        assert params.materials.metallicity.grad is not None
        assert (params.materials.roughness.grad is not None) == reparam


@pytest.mark.parametrize("base,rays", [(5000, 4096), (1 << 20, 1 << 19)])
def test_unsort_backward_matches_jax(base, rays):
    """The unsort's backward (a per-chunk gather by chunk-local id) against
    JAX's ``_unsort_bwd``, on blocks whose ids start above 0: one chunk and
    two 2^18-ray chunks. It equals the scatter autograd would do too."""
    rng = np.random.default_rng(rays)
    cs = wavefront.sort_chunk_size(rays)
    ids = (base + np.arange(rays)).astype(np.int32).reshape(-1, cs)
    for chunk in ids:
        rng.shuffle(chunk)
    ids = ids.reshape(-1)
    g = rng.normal(size=(rays, 3)).astype(np.float32)
    col = torch.zeros((rays, 3), requires_grad=True)
    out = wavefront._unsort_by_ray_id(col, torch.from_numpy(ids))
    out.backward(torch.from_numpy(g))
    ref, _ = jwavefront._unsort_bwd(jnp.asarray(ids), jnp.asarray(g))
    np.testing.assert_array_equal(col.grad.numpy(), np.asarray(ref))
    plain = torch.zeros((rays, 3), requires_grad=True)
    plain[wavefront._chunk_order(torch.from_numpy(ids))].backward(torch.from_numpy(g))
    assert torch.equal(plain.grad, col.grad)


@pytest.mark.parametrize("scene,reparam", [("torus", False), ("torus", True),
                                           ("metal_glass", True)])
def test_checkpoint_bounces_bit_equal(torus, scene, reparam):
    """Recomputing each bounce's shading in the backward pass gives the
    same loss and gradients bit for bit as storing it, and the backward pass
    runs no closest-hit search."""
    _, ts = torus if scene == "torus" else _brute(METAL_GLASS, env=True)
    w = torch.from_numpy(_weights(ts.num_pixels))
    out = []
    for checkpoint in (True, False):
        out.append(diff.render_and_grad(ts, loss_fn=lambda r: (r * w).sum(), pass_seed=2,
                                        rays_per_pixel=2, bounces=3, reparam=reparam,
                                        checkpoint_bounces=checkpoint))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(diff.param_leaves(g1), diff.param_leaves(g2)):
        assert torch.equal(a, b)
    assert any(bool(a.any()) for a in diff.param_leaves(g1))


def test_backward_runs_no_closest_hit(torus, monkeypatch):
    _, ts = torus
    params = diff.make_leaves(diff.split_params(ts)[0])
    loss = diff.render_radiance(params, ts, 0, 2, 3).sum()
    calls = []
    real = wavefront.closest_hit
    monkeypatch.setattr(wavefront, "closest_hit", lambda *a, **k: calls.append(1) or real(*a, **k))
    loss.backward()
    assert not calls and params.environment_map.grad is not None


def test_train_step_matches_optax():
    """Three steps of make_train_step with torch.optim.Adam against JAX's
    with optax.adam, from the same perturbed parameters (tests/test_diff.py's
    set-up): parameters within 1e-5 after every step, the loss falling."""
    import optax

    js, ts = _brute(CORNELL_MINI)
    true = diff.params_to_numpy(diff.split_params(ts)[0])
    start = {k: v.copy() for k, v in true.items()}
    start["materials.diffuse_albedo"][1, 0] -= 0.3
    start["materials.emitted"][0, 1] += 3.0
    jtarget = jdiff.render_radiance(_jax_params(js, true), js, jnp.uint32(7), 2, 3)
    target = diff.render_radiance(diff.params_from_numpy(true, "cpu"), ts, 7, 2, 3)

    jopt = optax.adam(3e-2)
    jstep = jdiff.make_train_step(js, jopt, rays_per_pixel=2, bounces=3)
    jp = _jax_params(js, start)
    jstate = jopt.init(jp)
    params = diff.params_from_numpy(start, "cpu", requires_grad=True)
    opt = torch.optim.Adam(diff.param_leaves(params), lr=3e-2)
    step = diff.make_train_step(ts, opt, rays_per_pixel=2, bounces=3)
    losses = []
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jtarget, jnp.uint32(7))
        loss = step(params, target, 7)
        losses.append(float(loss))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * float(jloss)
        got = diff.params_to_numpy(params)
        for name in diff.params_to_numpy(params):
            field = name.split(".")[-1]
            ref = (jp.environment_map if name == "environment_map"
                   else getattr(jp.materials, field))
            np.testing.assert_allclose(got[name], np.asarray(ref), rtol=0, atol=1e-5,
                                       err_msg=name)
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="param_leaves"):
        step(diff.make_leaves(params), target, 7)


def test_calibrate_and_audit_match_jax(torus):
    js, ts = torus
    ref = jdiff.calibrate_live_schedule(js, rays_per_pixel=2, bounces=4)
    got = diff.calibrate_live_schedule(ts, rays_per_pixel=2, bounces=4)
    assert got == ref and len(got) == 4 and max(got) > 1
    jtiny = js.replace(config=dataclasses.replace(js.config, packet_cap=1))
    suspects = diff.check_radiance_exact(ts.with_config(packet_cap=1))
    assert suspects == jdiff.check_radiance_exact(jtiny) > 0
    assert diff.check_radiance_exact(ts.with_config(packet_cap=ts.num_clusters)) == 0
    assert diff.check_radiance_exact(ts.with_config(packet_backend="pallas",
                                                    packet_cap=1)) > 0


def test_params_numpy_round_trip():
    js, ts = _brute(METAL_GLASS, env=True)
    arrays = diff.params_to_numpy(diff.split_params(ts)[0])
    assert len(arrays) == 7 and all(a.dtype == np.float32 for a in arrays.values())
    back = diff.params_from_numpy(arrays, "cpu")
    for a, b in zip(diff.param_leaves(back), diff.param_leaves(diff.split_params(ts)[0])):
        assert torch.equal(a, b) and not a.requires_grad
    jp = _jax_params(js, arrays)  # the JAX field names take the same arrays
    ref = jdiff.split_params(js)[0]
    for f in diff.MATERIAL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jp.materials, f)),
                                      np.asarray(getattr(ref.materials, f)))
    np.testing.assert_array_equal(np.asarray(jp.environment_map),
                                  np.asarray(ref.environment_map))


def test_material_lookup_one_hot_equals_gather():
    """``wavefront.material_rows`` against the row gathers it replaced: the
    same forward bits; the same gradient up to the sum's rounding; in
    detached mode no graph edge reaches roughness or ior."""
    _, ts = _brute(METAL_GLASS)
    rng = np.random.default_rng(0)
    M = ts.materials.diffuse_albedo.shape[0]
    mat_i = torch.from_numpy(rng.integers(0, M, 5000))
    w = torch.from_numpy(rng.normal(size=(5000, 12)).astype(np.float32))
    fields = ("diffuse_albedo", "specular_albedo", "emitted", "metallicity", "roughness",
              "index_of_refraction")

    def leaves():
        return diff.make_leaves(diff.split_params(ts)[0]).materials

    mats = leaves()
    rows = wavefront.material_rows(mats, mat_i)
    (rows * w).sum().backward()
    ref_mats = leaves()
    gathered = [getattr(ref_mats, f)[mat_i] for f in fields]
    ref = torch.cat([g if g.dim() == 2 else g[:, None] for g in gathered], dim=1)
    (ref * w).sum().backward()
    assert torch.equal(rows, ref.detach())
    for f in fields:
        got, want = getattr(mats, f).grad, getattr(ref_mats, f).grad
        assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max())), f
    detached = leaves()
    (wavefront.material_rows(detached, mat_i, sampling_grad=False) * w).sum().backward()
    assert detached.roughness.grad is None and detached.index_of_refraction.grad is None
    assert detached.metallicity.grad is not None
