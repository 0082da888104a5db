"""Native C++ tracer (ctypes) vs numpy brute force."""

import numpy as np
import pytest

from vkrt_jax.golden.cpu_tracer import closest_hit as brute_c
from vkrt_jax.golden.cpu_tracer import occluded as brute_o

from vkrt_jax import native


@pytest.fixture(scope="module")
def nat_scene():
    rng = np.random.default_rng(17)
    n = 3000
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, e1, e2, native.NativeBVH(v0, e1, e2)


def rays(n=512, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_native_closest_matches_brute(nat_scene):
    v0, e1, e2, bvh = nat_scene
    o, d = rays()
    tmax = np.full(o.shape[0], 1e3, np.float32)
    t, tri, u, v = bvh.closest(o, d, 0.001, tmax)
    bt, btri, bu, bv = brute_c(o, d, 0.001, 1e3, v0, e1, e2)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, btri >= 0)
    assert (tri[hit] == btri[hit]).mean() > 0.995
    same = hit & (tri == btri)
    np.testing.assert_allclose(t[same], bt[same], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(u[same], bu[same], atol=2e-4)


def test_native_occluded_matches_brute(nat_scene):
    v0, e1, e2, bvh = nat_scene
    o, d = rays(seed=5)
    rng = np.random.default_rng(6)
    tmax = rng.uniform(0.5, 20, o.shape[0]).astype(np.float32)
    occ = bvh.occluded(o, d, 0.001, tmax)
    bocc = brute_o(o, d, 0.001, tmax, v0, e1, e2)
    assert (occ == bocc).mean() > 0.995


def test_native_golden_render_matches_brute(subset_model):
    """Full-frame oracle parity: native-accelerated vs brute."""
    import dataclasses

    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.app.framebuffer import rmse
    from vkrt_jax.golden import render_golden
    from vkrt_jax.scene import build_texture_heap, flatten_model
    from vkrt_jax.scene.model import Model

    model = Model(submeshes=subset_model.submeshes[:4],
                  materials=subset_model.materials,
                  images=subset_model.images)
    flat = flatten_model(model)
    heap = build_texture_heap(model.images)
    cam = Camera(64, 48)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    cfg = dataclasses.replace(C.config2_shadows(), width=64, height=48)
    a = render_golden(flat, heap, cam.proj_inverse, cam.view_inverse, cfg,
                      accel="brute")
    b = render_golden(flat, heap, cam.proj_inverse, cam.view_inverse, cfg,
                      accel="native")
    assert rmse(a, b) <= 1e-3


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A library that cannot be built raises instead of leaving the
    golden gates without their oracle."""
    monkeypatch.setattr(native, "_DIR", str(tmp_path))      # no Makefile
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="failed"):
        native._build()
