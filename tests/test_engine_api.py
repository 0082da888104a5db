"""Renderer/Rasterizer class API end-to-end on CPU."""

import dataclasses

import numpy as np
import pytest

from conftest import TEXDIM
from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.app.flythrough import camera_path


@pytest.fixture(scope="module")
def small_cfg():
    return dataclasses.replace(C.config2_shadows(), width=64, height=48)


def test_renderer_class_full_scene(small_cfg):
    from vkrt_jax.wavefront.engine import Renderer
    r = Renderer(C.DEFAULT_SCENE, small_cfg, max_texture_dim=TEXDIM)
    cam = Camera(small_cfg.width, small_cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    fb, rays = r.render(cam)
    assert fb.shape == (48, 64, 3)
    assert np.isfinite(fb).all()
    assert rays >= 64 * 48                      # primaries + some shadow rays
    assert fb.max() > 0.1                       # something rendered

    # scene cache: a second renderer must reuse the device assets
    from vkrt_jax.wavefront import engine
    n_entries = len(engine._SCENE_CACHE)
    r2 = Renderer(C.DEFAULT_SCENE, small_cfg, max_texture_dim=TEXDIM)
    assert len(engine._SCENE_CACHE) == n_entries
    assert r2.backend is r.backend


def test_odd_resolution_padding(small_cfg):
    # 100x75 is not a multiple of the 32x16 tile — engine pads and crops
    from vkrt_jax.wavefront.engine import Renderer
    cfg = dataclasses.replace(small_cfg, width=100, height=75, num_lights=0,
                              enable_shadows=False, flat_albedo=True,
                              max_depth=1)
    r = Renderer(C.DEFAULT_SCENE, cfg, max_texture_dim=TEXDIM)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    fb, rays = r.render(cam)
    assert fb.shape == (75, 100, 3)
    assert np.isfinite(fb).all()
    assert rays == 100 * 75                     # padding rays never count


def test_midpath_camera_pose_golden(subset_model):
    """Golden compare at a NON-start pose (frame 80 of the fly-through) —
    catches pose-dependent ray-gen/tiling bugs the fixed-pose tests miss."""
    import jax.numpy as jnp

    from vkrt_jax.app.framebuffer import rmse
    from vkrt_jax.golden import render_golden
    from vkrt_jax.scene import build_texture_heap, flatten_model
    from vkrt_jax.wavefront.engine import (texture_arrays, make_backend,
                                           render_frame)

    flat = flatten_model(subset_model)
    heap = build_texture_heap(subset_model.images)
    tex = texture_arrays(subset_model.images, flat)
    backend = make_backend(flat)
    cams = list(camera_path(64, 48))
    cam = cams[80]
    cfg = dataclasses.replace(C.config2_shadows(), width=64, height=48)
    fb, _ = render_frame(backend, tex, jnp.asarray(cam.proj_inverse),
                         jnp.asarray(cam.view_inverse),
                         jnp.asarray(C.LIGHT_POSITIONS), cfg)
    golden = render_golden(flat, heap, cam.proj_inverse, cam.view_inverse, cfg)
    assert rmse(np.asarray(fb), golden) <= 1e-3
