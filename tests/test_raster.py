"""Raster pipeline vs its brute-force oracle + overlay sanity."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.app.framebuffer import rmse
from vkrt_jax.app.overlay import draw_text
from vkrt_jax.golden.raster_oracle import render_golden_raster
from vkrt_jax.raster import render_raster_frame
from vkrt_jax.scene import build_texture_heap, flatten_model
from vkrt_jax.wavefront.engine import make_backend, texture_arrays

W, H = 64, 48


@pytest.fixture(scope="module")
def scene(subset_model):
    model = subset_model
    flat = flatten_model(model)
    heap = build_texture_heap(model.images)
    tex = texture_arrays(model.images, flat)
    backend = make_backend(flat)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return flat, heap, tex, backend, cam


def test_raster_matches_oracle_noaa(scene):
    flat, heap, tex, backend, cam = scene
    cfg = dataclasses.replace(C.reference_config(), width=W, height=H)
    fb = np.asarray(render_raster_frame(
        backend, tex, jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), cfg, msaa=1))
    golden = render_golden_raster(flat, heap, cam.proj_inverse,
                                  cam.view_inverse, cfg, msaa=1)
    assert rmse(fb, golden) <= 1e-3


def test_raster_msaa8_smooths_edges(scene):
    flat, heap, tex, backend, cam = scene
    cfg = dataclasses.replace(C.reference_config(), width=W, height=H)
    aa = np.asarray(render_raster_frame(
        backend, tex, jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), cfg, msaa=8))
    golden = render_golden_raster(flat, heap, cam.proj_inverse,
                                  cam.view_inverse, cfg, msaa=8)
    assert rmse(aa, golden) <= 1e-3
    assert np.isfinite(aa).all()


def test_overlay_draws_pixels():
    fb = np.zeros((64, 128, 3), np.float32)
    out = draw_text(fb, "FPS 60.0", 4, 4)
    assert out.max() == 1.0
    assert (out != fb).any()
    assert (fb == 0).all()  # original untouched


def test_raster_native_oracle_matches_brute(scene):
    """The raster oracle's native-BVH visibility (used for full-scene
    frames) agrees with its brute-force form."""
    flat, heap, _, _, cam = scene
    cfg = dataclasses.replace(C.reference_config(), width=32, height=24)
    a = render_golden_raster(flat, heap, cam.proj_inverse, cam.view_inverse,
                             cfg, msaa=1)
    b = render_golden_raster(flat, heap, cam.proj_inverse, cam.view_inverse,
                             cfg, msaa=1, accel="native")
    assert rmse(a, b) <= 1e-3
