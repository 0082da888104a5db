"""Traversal vs brute force — the RT-core replacement must agree exactly."""

import jax.numpy as jnp
import numpy as np

from vkrt_jax.accel import build_lbvh
from vkrt_jax.golden.cpu_tracer import closest_hit as brute_closest
from vkrt_jax.golden.cpu_tracer import occluded as brute_occluded
from vkrt_jax.rt import trace_closest, trace_occluded


def make_scene(rng, n_tris=300):
    v0 = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def make_rays(rng, n_rays=256):
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_closest_matches_brute_force(rng):
    v0, e1, e2 = make_scene(rng)
    o, d = make_rays(rng)
    bvh = build_lbvh(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    t, tri, u, v = trace_closest(bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3)
    bt, btri, bu, bv = brute_closest(o, d, 1e-3, 1e3, v0, e1, e2)

    hit = np.asarray(tri) >= 0
    bhit = btri >= 0
    np.testing.assert_array_equal(hit, bhit)
    # distances agree tightly; tri ids agree except exact-tie cases
    np.testing.assert_allclose(np.asarray(t)[hit], bt[bhit], rtol=1e-4, atol=1e-5)
    agree = np.asarray(tri)[hit] == btri[bhit]
    assert agree.mean() > 0.99
    np.testing.assert_allclose(np.asarray(u)[hit][agree], bu[bhit][agree], atol=1e-4)
    np.testing.assert_allclose(np.asarray(v)[hit][agree], bv[bhit][agree], atol=1e-4)


def test_occlusion_matches_brute_force(rng):
    v0, e1, e2 = make_scene(rng)
    o, d = make_rays(rng)
    tmax = rng.uniform(0.5, 20.0, size=(o.shape[0],)).astype(np.float32)
    bvh = build_lbvh(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    occ = trace_occluded(bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tmax))
    bocc = brute_occluded(o, d, 1e-3, tmax, v0, e1, e2)
    # Boundary-epsilon cases (t == tmax within float error) may differ; require
    # near-perfect agreement.
    assert (np.asarray(occ) == bocc).mean() > 0.995


def test_axis_parallel_rays(rng):
    # rays with zero direction components exercise safe_inv_dir
    v0 = np.array([[0, 0, 5], [0, 0, -5]], dtype=np.float32)
    e1 = np.array([[1, 0, 0], [1, 0, 0]], dtype=np.float32)
    e2 = np.array([[0, 1, 0], [0, 1, 0]], dtype=np.float32)
    bvh = build_lbvh(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    o = np.array([[0.25, 0.25, 0.0], [0.25, 0.25, 0.0]], dtype=np.float32)
    d = np.array([[0, 0, 1], [0, 0, -1]], dtype=np.float32)
    t, tri, u, v = trace_closest(bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3)
    assert np.asarray(tri).tolist() == [0, 1]
    np.testing.assert_allclose(np.asarray(t), [5.0, 5.0], rtol=1e-5)


def test_degenerate_triangles_never_hit(rng):
    # zero-area padding triangles (synth scene) must be rejected
    v0 = np.zeros((4, 3), dtype=np.float32)
    e1 = np.zeros((4, 3), dtype=np.float32)
    e2 = np.zeros((4, 3), dtype=np.float32)
    v0[0], e1[0], e2[0] = [0, 0, 3], [1, 0, 0], [0, 1, 0]  # one real tri
    bvh = build_lbvh(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    o = np.array([[0.2, 0.2, 0.0]], dtype=np.float32)
    d = np.array([[0, 0, 1.0]], dtype=np.float32)
    t, tri, u, v = trace_closest(bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3)
    assert int(tri[0]) == 0
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-5)


def test_miss_returns_minus_one(rng):
    v0, e1, e2 = make_scene(rng, 50)
    bvh = build_lbvh(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    o = np.array([[100.0, 100, 100]], dtype=np.float32)
    d = np.array([[1.0, 0, 0]], dtype=np.float32)
    t, tri, u, v = trace_closest(bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e3)
    assert int(tri[0]) == -1
