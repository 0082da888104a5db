"""Radix-partition permutation machinery (wavefront/resort.py)."""

import jax.numpy as jnp
import numpy as np

from vkrt_jax.wavefront.resort import (CELL_KEY_BITS, OCTANT_BITS, cell_key,
                                       inverse_permutation, octant_key,
                                       permute_rays, radix_partition_perm)


def test_radix_partition_matches_stable_argsort(rng):
    for nbits in (1, 4, 10):
        key = rng.integers(0, 1 << nbits, 2048).astype(np.int32)
        perm = np.asarray(radix_partition_perm(jnp.asarray(key), nbits))
        np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))


def test_inverse_permutation_roundtrip(rng):
    perm = rng.permutation(4096).astype(np.int32)
    inv = np.asarray(inverse_permutation(jnp.asarray(perm)))
    np.testing.assert_array_equal(perm[inv], np.arange(4096))
    arr = rng.standard_normal((7, 32, 128)).astype(np.float32)
    fwd = permute_rays(jnp.asarray(arr), jnp.asarray(perm))
    back = permute_rays(fwd, jnp.asarray(inv))
    np.testing.assert_array_equal(np.asarray(back), arr)


def test_octant_key_groups_directions(rng):
    d = rng.standard_normal((3, 8, 128)).astype(np.float32)
    live = rng.random((8, 128)) < 0.5
    key = np.asarray(octant_key(jnp.asarray(d), jnp.asarray(live)))
    assert key.max() <= 8 and (1 << OCTANT_BITS) > 8
    flat_live = live.reshape(-1)
    assert (key[~flat_live] == 8).all()
    dx = d[0].reshape(-1)
    assert ((key[flat_live] & 1) == (dx[flat_live] < 0)).all()


def test_cell_key_dead_rays_sort_to_tail(rng):
    p = rng.uniform(-5, 5, (3, 8, 128)).astype(np.float32)
    live = rng.random((8, 128)) < 0.5
    aabb = jnp.asarray([[-5.0, -5.0, -5.0], [5.0, 5.0, 5.0]])
    key = np.asarray(cell_key(jnp.asarray(p), jnp.asarray(live), aabb))
    assert key.max() < (1 << CELL_KEY_BITS)
    flat_live = live.reshape(-1)
    assert (key[~flat_live] > key[flat_live].max()).all()
    # nearby points share cells: a tight cloud lands in few cells
    tight = jnp.asarray(np.full((3, 8, 128), 1.23, np.float32))
    k2 = np.asarray(cell_key(tight, jnp.asarray(np.ones((8, 128), bool)),
                             aabb))
    assert len(np.unique(k2)) == 1
