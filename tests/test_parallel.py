"""Multi-device sharding on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.parallel import make_mesh, render_frame_sharded
from vkrt_jax.wavefront.engine import render_frame


def _jit(fn, **static):
    import functools
    return jax.jit(functools.partial(fn, **static))


def _cam_args(cfg):
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return (jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
            jnp.asarray(C.LIGHT_POSITIONS))


@pytest.fixture(scope="module")
def subset_scene(subset_model):
    from vkrt_jax.scene import flatten_model
    from vkrt_jax.wavefront.engine import make_backend, texture_arrays
    flat = flatten_model(subset_model)
    return make_backend(flat), texture_arrays(subset_model.images, flat)


def test_sharded_matches_single_device():
    import __graft_entry__ as g
    backend, tex, _ = g._tiny_scene()
    cfg = C.RenderConfig(width=64, height=48, max_depth=2, num_lights=2,
                         enable_shadows=True, enable_reflections=True)
    args = _cam_args(cfg)

    single_fb, single_rays = _jit(render_frame, cfg=cfg)(backend, tex,
                                                          *args)

    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    mesh = make_mesh()
    fb, rays = _jit(render_frame_sharded, cfg=cfg, mesh=mesh)(
        backend, tex, *args)

    np.testing.assert_allclose(np.asarray(fb), np.asarray(single_fb),
                               atol=1e-5)
    assert int(np.asarray(rays).sum()) == int(np.asarray(single_rays).sum())


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("rays",)


def test_sharded_generated_subset_with_resort(subset_scene):
    """The production path under shard_map on generated-scene data:
    sharded == single-device, also with the secondary resort (the radix
    partition runs per shard — no collective). allclose: the reflection
    round's near-tie commits are visit-order dependent at ~1 ulp."""
    import dataclasses

    backend, tex = subset_scene
    cfg = C.RenderConfig(width=64, height=32, max_depth=2, num_lights=2,
                         enable_shadows=True, enable_reflections=True)
    args = _cam_args(cfg)
    single_fb, single_rays = _jit(render_frame, cfg=cfg)(backend, tex,
                                                          *args)
    mesh = make_mesh()
    for rs in (False, True):
        fb, rays = _jit(render_frame_sharded, mesh=mesh,
                        cfg=dataclasses.replace(cfg, resort_secondary=rs))(
            backend, tex, *args)
        np.testing.assert_allclose(np.asarray(fb), np.asarray(single_fb),
                                   atol=1e-5)
        assert (int(np.asarray(rays).sum())
                == int(np.asarray(single_rays).sum()))


def test_sharded_raster_matches_single_device(subset_scene):
    """The ray-cast raster under shard_map (each MSAA sample's pixel
    blocks split, scene replicated): sharded == single-device. One
    sample: the 8-sample resolve runs the same body per offset."""
    from vkrt_jax.parallel.mesh import render_raster_frame_sharded
    from vkrt_jax.raster import render_raster_frame

    backend, tex = subset_scene
    cfg = C.RenderConfig(width=64, height=32)
    pi, vi, _ = _cam_args(cfg)
    mesh = make_mesh()
    single = np.asarray(_jit(render_raster_frame, cfg=cfg, msaa=1)(
        backend, tex, pi, vi))
    sharded = np.asarray(_jit(render_raster_frame_sharded, cfg=cfg,
                              mesh=mesh, msaa=1)(backend, tex, pi, vi))
    assert np.isfinite(sharded).all()
    np.testing.assert_allclose(sharded, single, atol=1e-6)
