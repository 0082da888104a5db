"""Per-frame accel update (config 5): transform + on-device LBVH rebuild
(wavefront/engine.rebuild_backend)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import TEXDIM
from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.rt.traverse import trace_closest
from vkrt_jax.wavefront.engine import (build_backend, load_scene_assets,
                                       rebuild_backend)


def rot_y(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


@pytest.fixture(scope="module")
def soup():
    """A random triangle soup as an attribute table + static backend."""
    rng = np.random.default_rng(11)
    n = 400
    table = np.zeros((n, 36), np.float32)
    table[:, 0:3] = rng.uniform(-5, 5, (n, 3))
    table[:, 3:9] = rng.uniform(-1, 1, (n, 6))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    table[:, 9:18] = np.tile(nrm, 3)
    table[:, 18:24] = rng.uniform(0, 1, (n, 6))
    table[:, 24:33] = np.tile(nrm[:, [1, 2, 0]], 3)
    table[:, 33] = np.arange(n) % 3
    p = table[:, 0:3]
    aabb = np.stack([p.min(0), (p + 1).max(0)]).astype(np.float32)
    be = build_backend(jnp.asarray(table), jnp.asarray(aabb))
    rays_o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
    rays_d = rng.normal(size=(256, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=1, keepdims=True)
    return table, be, rays_o, rays_d


def _trace(be, o, d):
    t, tri, u, v = trace_closest(be.bvh, jnp.asarray(o), jnp.asarray(d),
                                 C.RAY_TMIN, C.RAY_TMAX)
    return np.asarray(t), np.asarray(tri)


def test_identity_rebuild_is_static(soup):
    table, be, o, d = soup
    rb = rebuild_backend(be.attr_table, be.scene_aabb, jnp.eye(4))
    np.testing.assert_array_equal(np.asarray(rb.attr_table), table)
    np.testing.assert_array_equal(np.asarray(rb.bvh.kids),
                                  np.asarray(be.bvh.kids))
    np.testing.assert_array_equal(np.asarray(rb.bvh.boxes),
                                  np.asarray(be.bvh.boxes))
    np.testing.assert_array_equal(np.asarray(rb.scene_aabb),
                                  np.asarray(be.scene_aabb))


def test_translated_rebuild_traces_shifted_rays(soup):
    """Translating the scene by b and the rays by b gives the same hits."""
    _, be, o, d = soup
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [3.0, -2.0, 0.5]
    rb = rebuild_backend(be.attr_table, be.scene_aabb, jnp.asarray(m))
    t0, tri0 = _trace(be, o, d)
    t1, tri1 = _trace(rb, o + m[:3, 3], d)
    np.testing.assert_array_equal(tri0 >= 0, tri1 >= 0)
    hit = tri0 >= 0
    assert (tri0[hit] == tri1[hit]).mean() > 0.99
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rb.scene_aabb),
                               np.asarray(be.scene_aabb) + m[:3, 3],
                               atol=1e-5)


def test_scaled_rebuild_scales_distances_and_boxes(soup):
    _, be, o, d = soup
    m = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    rb = rebuild_backend(be.attr_table, be.scene_aabb, jnp.asarray(m))
    t0, tri0 = _trace(be, o, d)
    t1, tri1 = _trace(rb, 2.0 * o, d)
    hit = tri0 >= 0
    np.testing.assert_array_equal(hit, tri1 >= 0)
    np.testing.assert_allclose(t1[hit], 2.0 * t0[hit], rtol=1e-4)
    # root child boxes scale with the geometry
    np.testing.assert_allclose(np.asarray(rb.bvh.boxes)[0],
                               2.0 * np.asarray(be.bvh.boxes)[0], rtol=1e-5)


def test_rebuild_rotates_normals_and_tangents(soup):
    table, be, _, _ = soup
    m = rot_y(0.7)
    rb = rebuild_backend(be.attr_table, be.scene_aabb, jnp.asarray(m))
    got = np.asarray(rb.attr_table)
    a = m[:3, :3]
    for k in (3, 6, 9, 12, 15, 24, 27, 30):     # edges, normals, tangents
        np.testing.assert_allclose(got[:, k:k + 3], table[:, k:k + 3] @ a.T,
                                   atol=1e-5)
    np.testing.assert_allclose(got[:, 0:3], table[:, 0:3] @ a.T, atol=1e-5)
    # uvs and material ids ride along unchanged
    np.testing.assert_array_equal(got[:, 18:24], table[:, 18:24])
    np.testing.assert_array_equal(got[:, 33:36], table[:, 33:36])


def test_renderer_transform_matches_pretransformed_scene(ref_flat):
    """Renderer.render(transform=m) on the generated scene equals the
    static render of the same scene transformed on the host."""
    from vkrt_jax.wavefront.engine import (Renderer, make_backend,
                                           render_frame)

    cfg = dataclasses.replace(C.config1_primary(), width=64, height=48)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    m = rot_y(0.05)
    m[:3, 3] = [0.1, 0.0, -0.1]
    r = Renderer(C.DEFAULT_SCENE, cfg, max_texture_dim=TEXDIM)
    fb, rays = r.render(cam, transform=m)

    a = m[:3, :3]
    flat_t = dataclasses.replace(
        ref_flat,
        positions=(ref_flat.positions @ a.T + m[:3, 3]).astype(np.float32),
        normals=(ref_flat.normals @ a.T).astype(np.float32),
        tangents=np.concatenate([ref_flat.tangents[:, :3] @ a.T,
                                 ref_flat.tangents[:, 3:]],
                                axis=1).astype(np.float32))
    _, tex, _ = load_scene_assets(C.DEFAULT_SCENE, TEXDIM)
    fb_t, rays_t = render_frame(make_backend(flat_t), tex,
                                jnp.asarray(cam.proj_inverse),
                                jnp.asarray(cam.view_inverse),
                                jnp.asarray(C.LIGHT_POSITIONS), cfg)
    assert rays == int(np.asarray(rays_t).sum())
    from vkrt_jax.app.framebuffer import rmse
    assert rmse(fb, np.asarray(fb_t)) <= 1e-3
