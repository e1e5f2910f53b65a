"""The comparison catches a broken timed path: each fault a cell can have
is planted under a toy run on the CPU, and ``correct`` must come out
false. (A one-chip cell has no exchange between chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu_torch.render import diff, pipeline
from rtbench.tests.test_rtbench_run import drive


def _state_unchanged(monkeypatch):
    def render(scene, *args, **kwargs):
        return torch.zeros((scene.num_pixels, 3), device=scene.device)

    monkeypatch.setattr(pipeline, "render_framebuffer", render)


def _half_batch(monkeypatch):
    real = pipeline.render_framebuffer

    def render(scene, *args, **kwargs):
        spp = scene.config.rays_per_pixel
        half = max(1, spp // 2)
        return real(scene.with_config(rays_per_pixel=half), *args, **kwargs) * (spp / half)

    monkeypatch.setattr(pipeline, "render_framebuffer", render)


def _framebuffer_altered(monkeypatch):
    real = pipeline.render_framebuffer
    monkeypatch.setattr(pipeline, "render_framebuffer", lambda *a, **k: real(*a, **k) * 1.05)


def _image_altered(monkeypatch):
    real = pipeline.render_image

    def image(*args, **kwargs):
        out = np.array(real(*args, **kwargs))
        out[0, 0] ^= 0x40
        return out

    monkeypatch.setattr(pipeline, "render_image", image)


IMAGE_FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
                "framebuffer_altered": _framebuffer_altered, "image_altered": _image_altered}


@pytest.mark.parametrize("fault", sorted(IMAGE_FAULTS))
@pytest.mark.parametrize("cell", ["toy_torus.image", "toy_cornell.image"])
def test_image_fault_is_caught(toy_root, monkeypatch, cell, fault):
    IMAGE_FAULTS[fault](monkeypatch)
    rc, result, err = drive(toy_root, cell, 21)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


def _step_unchanged(monkeypatch):
    real = diff.make_train_step

    def make(scene, optimizer, *args, **kwargs):
        optimizer.step = lambda *a, **k: None
        return real(scene, optimizer, *args, **kwargs)

    monkeypatch.setattr(diff, "make_train_step", make)


def _loss_half_batch(monkeypatch):
    def loss(params, scene, target, pass_seed, rays_per_pixel, bounces, *args, **kwargs):
        rendered = diff.render_radiance(params, scene, pass_seed, rays_per_pixel, bounces)
        half = rendered.shape[0] // 2
        return torch.mean((rendered[:half] - target[:half]) ** 2)

    monkeypatch.setattr(diff, "loss_against_target", loss)


def _radiance_altered(monkeypatch):
    real = diff.render_radiance
    monkeypatch.setattr(diff, "render_radiance", lambda *a, **k: real(*a, **k) * 1.05)


TRAIN_FAULTS = {"state_unchanged": _step_unchanged, "half_batch": _loss_half_batch,
                "radiance_altered": _radiance_altered}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(toy_root, monkeypatch, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    rc, result, err = drive(toy_root, "toy_torus.train", 21)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
