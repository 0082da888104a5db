"""Device material-sampler vs the oracle sampler — bilinear/repeat parity.

The device samples all three maps of a material slot in one gather from
the packed 48-byte material heap (scene/textures.py build_material_heap);
the oracle (golden/cpu_tracer.sample_texture) samples original per-image
data independently.
"""

import jax.numpy as jnp
import numpy as np

from vkrt_jax.golden.cpu_tracer import sample_texture
from vkrt_jax.scene.model import Image
from vkrt_jax.scene.textures import (bilinear_resize, build_material_heap,
                                     build_texture_heap)
from vkrt_jax.shade.sampling import sample_material
from vkrt_jax.utils import layout as L


def make_images(rng):
    return [Image(width=16, height=8,
                  data=rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)),
            Image(width=16, height=8,
                  data=rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)),
            Image(width=16, height=8,
                  data=rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)),
            Image(width=4, height=4,
                  data=rng.integers(0, 256, (4, 4, 4)).astype(np.uint8))]


def run_sampler(heap, slot_ids, uv):
    out = sample_material(jnp.asarray(heap.texels_tri),
                          jnp.asarray(heap.level_offset),
                          jnp.asarray(heap.level_width),
                          jnp.asarray(heap.level_height),
                          L.to_lanes(jnp.asarray(slot_ids)),
                          jnp.stack([L.to_lanes(jnp.asarray(uv[:, 0])),
                                     L.to_lanes(jnp.asarray(uv[:, 1]))]))
    return [np.stack([L.from_lanes(m[c]) for c in range(4)], axis=1)
            for m in out]


def test_material_sampler_matches_oracle(rng):
    imgs = make_images(rng)
    triples = np.array([[0, 1, 2], [2, 0, 1]], np.int32)  # co-sized maps
    heap = build_material_heap(imgs, triples)
    oracle_heap = build_texture_heap(imgs)

    n = 256
    slots = rng.integers(0, 2, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)  # exercises wrap
    got = run_sampler(heap, slots, uv)
    for k in range(3):
        img_ids = triples[slots, k].astype(np.int64)
        want = sample_texture(oracle_heap, img_ids, uv)
        np.testing.assert_allclose(got[k], want, atol=1e-5)


def test_material_heap_mixed_sizes(rng):
    """A slot mixing a 4x4 map with 16x8 maps: the small map is co-sized
    by bilinear resize. Resampling a resized map deviates from the
    original's reconstruction near the original's knots (kink
    misalignment, bounded by neighbor-delta x fine/coarse ratio); for a
    CONSTANT small map — the only mismatched case in Sponza, a solid
    4x4 fallback — the resize is exact."""
    imgs = make_images(rng)
    # constant 4x4 base (the Sponza material-2 shape): must be exact
    imgs[3] = Image(width=4, height=4,
                    data=np.full((4, 4, 4), 197, np.uint8))
    triples = np.array([[3, 1, 2]], np.int32)
    heap = build_material_heap(imgs, triples)
    oracle_heap = build_texture_heap(imgs)

    n = 256
    slots = np.zeros(n, np.int32)
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    got = run_sampler(heap, slots, uv)
    want = sample_texture(oracle_heap, np.full(n, 3, np.int64), uv)
    np.testing.assert_allclose(got[0], want, atol=1e-5)    # constant: exact
    for k, img in ((1, 1), (2, 2)):                        # untouched maps
        want = sample_texture(oracle_heap, np.full(n, img, np.int64), uv)
        np.testing.assert_allclose(got[k], want, atol=1e-5)

    # random (worst-case) mismatched content stays within the kink bound
    imgs2 = make_images(rng)
    heap2 = build_material_heap(imgs2, triples)
    oracle2 = build_texture_heap(imgs2)
    got2 = run_sampler(heap2, slots, uv)
    want2 = sample_texture(oracle2, np.full(n, 3, np.int64), uv)
    assert np.abs(got2[0] - want2).max() < 0.3


def test_bilinear_resize_identity_and_upsample():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (4, 4, 4)).astype(np.uint8)
    np.testing.assert_array_equal(bilinear_resize(img, 4, 4), img)
    up = bilinear_resize(img, 12, 12)
    # odd-factor upsample preserves original texel values at the aligned
    # centers: output texel x = 3k+1 maps to source coordinate
    # (x+0.5)/12*4-0.5 = k exactly
    np.testing.assert_array_equal(up[1::3, 1::3], img)


def test_layout_roundtrips(rng):
    x = rng.normal(size=(512,)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(L.from_lanes(L.to_lanes(jnp.asarray(x)))), x)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(L.from_cvec(L.to_cvec(jnp.asarray(v)))), v)
    a = L.to_cvec(jnp.asarray(v))
    b = L.to_cvec(jnp.asarray(rng.normal(size=(512, 3)).astype(np.float32)))
    np.testing.assert_allclose(
        np.asarray(L.dot3(a, b)).reshape(-1),
        (v * np.asarray(L.from_cvec(b))).sum(axis=1), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(L.from_cvec(L.cross3(a, b))),
        np.cross(v, np.asarray(L.from_cvec(b))), rtol=2e-5, atol=1e-5)


def test_compact_sampler_matches_full(rng):
    """sample_material_compact == sample_material on live lanes, zeros on
    dead rows, for any liveness pattern (incl. all-dead and all-live)."""
    from vkrt_jax.scene.textures import build_material_heap
    from vkrt_jax.shade.sampling import sample_material_compact

    imgs = make_images(rng)
    triples = np.array([[0, 1, 2], [2, 0, 1]], np.int32)
    heap = build_material_heap(imgs, triples)
    args = (jnp.asarray(heap.texels_tri), jnp.asarray(heap.level_offset),
            jnp.asarray(heap.level_width), jnp.asarray(heap.level_height))

    nb = 16
    sid = jnp.asarray(rng.integers(0, 2, (nb, 128)), jnp.int32)
    uv = jnp.asarray(rng.uniform(-2, 3, (2, nb, 128)), jnp.float32)
    full = sample_material(*args, sid, uv)

    for pattern in ("sparse", "none", "all"):
        if pattern == "sparse":
            live = jnp.asarray(rng.random((nb, 128)) < 0.2)
        elif pattern == "none":
            live = jnp.zeros((nb, 128), bool)
        else:
            live = jnp.ones((nb, 128), bool)
        got = sample_material_compact(*args, sid, uv, live, cap_rows=8)
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(got[k])[:, np.asarray(live)],
                np.asarray(full[k])[:, np.asarray(live)], atol=1e-6)
            dead_rows = ~np.asarray(jnp.any(live, axis=1))
            assert (np.asarray(got[k])[:, dead_rows] == 0).all()


def test_trilinear_lod_blends_mip_levels(rng):
    """Per-ray mip LOD (beyond-parity, config.mip_lod): lod 0 must equal
    the base sampler; integer lod k must equal static-level sampling;
    fractional lod must blend the bracketing levels linearly."""
    from vkrt_jax.shade.sampling import sample_material_trilinear

    imgs = make_images(rng)
    triples = np.array([[0, 1, 2]], np.int32)
    heap = build_material_heap(imgs, triples)
    args = (jnp.asarray(heap.texels_tri), jnp.asarray(heap.level_offset),
            jnp.asarray(heap.level_width), jnp.asarray(heap.level_height))
    n = 128
    sid = L.to_lanes(jnp.zeros(n, jnp.int32))
    uvr = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    uv = jnp.stack([L.to_lanes(jnp.asarray(uvr[:, 0])),
                    L.to_lanes(jnp.asarray(uvr[:, 1]))])
    base0 = sample_material(*args, sid, uv, lod=0)
    base1 = sample_material(*args, sid, uv, lod=1)
    tri0 = sample_material_trilinear(*args, sid, uv,
                                     jnp.zeros_like(uv[0]))
    tri1 = sample_material_trilinear(*args, sid, uv,
                                     jnp.ones_like(uv[0]))
    half = sample_material_trilinear(*args, sid, uv,
                                     jnp.full_like(uv[0], 0.5))
    for a, b in zip(base0, tri0):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    for a, b in zip(base1, tri1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    for lo, hi, m in zip(base0, base1, half):
        np.testing.assert_allclose(np.asarray(m),
                                   0.5 * (np.asarray(lo) + np.asarray(hi)),
                                   atol=1e-6)


def test_ray_diff_lod_scales_with_footprint(rng):
    """Far/minified surfaces (large uv steps across lanes) must select a
    higher mip; a 1-texel-per-pixel footprint stays at lod 0; surface
    boundaries (mat change / miss) clamp to 0."""
    from vkrt_jax.shade.sampling import ray_diff_lod

    lw = jnp.full((1, 6), 16, jnp.int32)
    lh = jnp.full((1, 6), 8, jnp.int32)
    n_rows = 2
    sid = jnp.zeros((n_rows, 128), jnp.int32)
    hit = jnp.ones((n_rows, 128), bool)
    lane = np.arange(128, dtype=np.float32)
    # row 0: 1 texel/pixel in u (du = 1/16 per lane) → lod 0
    # row 1: 4 texels/pixel → lod 2
    u = np.stack([lane / 16.0, lane * 4.0 / 16.0]) % 1.0
    u = u.astype(np.float32)
    uv = jnp.stack([jnp.asarray(u), jnp.zeros((n_rows, 128), jnp.float32)])
    lod = np.asarray(ray_diff_lod(uv, hit, sid, lw, lh, sid))
    # ignore the 16-lane wrap seams (x-neighbor rolls across subtile rows)
    interior = np.ones(128, bool)
    interior[::16] = False
    # wrap-around texels (u jumps from 15/16 to 0) also alias
    interior &= (np.abs(np.diff(u[0], prepend=u[0][0])) < 0.5)
    interior &= (np.abs(np.diff(u[1], prepend=u[1][0])) < 0.5)
    assert np.allclose(lod[0][interior], 0.0, atol=0.1)
    assert np.allclose(lod[1][interior], 2.0, atol=0.1)
    # boundary clamp: alternate materials → lod 0 everywhere
    sid2 = jnp.asarray((np.arange(128) % 2).astype(np.int32))[None].repeat(
        n_rows, 0)
    lod2 = np.asarray(ray_diff_lod(uv, hit, sid2, lw, lh, sid2 * 0))
    assert np.allclose(lod2, 0.0)
