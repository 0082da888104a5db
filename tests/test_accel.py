"""LBVH structural invariants (ref contract: driver BLAS, Raytracer.cpp:1027-1157)."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkrt_jax.accel import build_lbvh, morton30


def random_tris(rng, n):
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)


def walk_leaves(kids):
    """Host-side DFS from root; returns leaf slots in visit order."""
    kids = np.asarray(kids)
    leaves = []
    stack = [0]
    seen_internal = set()
    while stack:
        n = stack.pop()
        assert n not in seen_internal, "cycle in BVH"
        seen_internal.add(n)
        for c in kids[n]:
            if c < 0:
                leaves.append(-c - 1)
            else:
                stack.append(int(c))
    return leaves, seen_internal


@pytest.mark.parametrize("n", [2, 3, 7, 64, 1000])
def test_lbvh_covers_all_leaves_once(rng, n):
    v0, e1, e2 = random_tris(rng, n)
    bvh = build_lbvh(v0, e1, e2)
    leaves, internals = walk_leaves(bvh.kids)
    assert sorted(leaves) == list(range(n))
    assert len(internals) == n - 1


def test_lbvh_duplicate_morton_codes(rng):
    # all triangles at the same position → identical codes; index tie-break
    # must still produce a valid topology
    v0 = jnp.zeros((33, 3), dtype=jnp.float32)
    e1 = jnp.tile(jnp.asarray([[1.0, 0, 0]]), (33, 1))
    e2 = jnp.tile(jnp.asarray([[0, 1.0, 0]]), (33, 1))
    bvh = build_lbvh(v0, e1, e2)
    leaves, _ = walk_leaves(bvh.kids)
    assert sorted(leaves) == list(range(33))


def test_node_boxes_contain_descendants(rng):
    n = 500
    v0, e1, e2 = random_tris(rng, n)
    bvh = build_lbvh(v0, e1, e2)
    kids = np.asarray(bvh.kids)
    boxes = np.asarray(bvh.boxes)
    tv0 = np.asarray(bvh.tri_v0)
    te1 = np.asarray(bvh.tri_e1)
    te2 = np.asarray(bvh.tri_e2)
    leaf_min = np.minimum(np.minimum(tv0, tv0 + te1), tv0 + te2)
    leaf_max = np.maximum(np.maximum(tv0, tv0 + te1), tv0 + te2)

    def node_box(n):
        """true union of all leaf boxes under internal node n"""
        leaves = []
        stack = [n]
        while stack:
            c = stack.pop()
            for k in kids[c]:
                if k < 0:
                    leaves.append(-k - 1)
                else:
                    stack.append(int(k))
        return leaf_min[leaves].min(0), leaf_max[leaves].max(0)

    for node in [0, 1, n // 2, n - 2]:
        for side, (blo, bhi) in enumerate([(boxes[node, 0:3], boxes[node, 3:6]),
                                           (boxes[node, 6:9], boxes[node, 9:12])]):
            k = kids[node, side]
            if k < 0:
                lo, hi = leaf_min[-k - 1], leaf_max[-k - 1]
            else:
                lo, hi = node_box(int(k))
            np.testing.assert_allclose(blo, lo, atol=1e-5)
            np.testing.assert_allclose(bhi, hi, atol=1e-5)


def test_morton_ordering_groups_nearby_points():
    pts = jnp.asarray(np.array([[0, 0, 0], [0.01, 0, 0], [10, 10, 10]], dtype=np.float32))
    lo = jnp.min(pts, axis=0)
    hi = jnp.max(pts, axis=0)
    codes = np.asarray(morton30(pts, lo, hi))
    assert abs(int(codes[0]) - int(codes[1])) < abs(int(codes[0]) - int(codes[2]))


def test_lbvh_jit_rebuild_stability(rng):
    # per-frame rebuild path (config 5): building twice must be identical
    v0, e1, e2 = random_tris(rng, 256)
    b1 = build_lbvh(v0, e1, e2)
    b2 = build_lbvh(v0, e1, e2)
    np.testing.assert_array_equal(np.asarray(b1.kids), np.asarray(b2.kids))
    np.testing.assert_array_equal(np.asarray(b1.leaf_tri), np.asarray(b2.leaf_tri))
