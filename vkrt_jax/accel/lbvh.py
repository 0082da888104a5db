"""LBVH construction — the replacement for driver BLAS/TLAS builds.

The reference delegates acceleration-structure construction to the Vulkan
driver (`vkCmdBuildAccelerationStructuresKHR`, ref: src/Raytracer.cpp:
1027-1283 — one BLAS over 103 triangle geometries + one 1-instance TLAS).
Here we implement what the driver does: a linear BVH (Karras 2012 style)
built entirely on device with jit-clean, fixed-shape vector code so it can
run per frame (BASELINE config 5, per-frame rebuild):

  1. triangle centroids → 30-bit Morton codes (10 bits/axis)
  2. argsort (XLA radix sort on device)
  3. internal-node ranges/splits via vectorized binary searches over
     longest-common-prefix "delta" values (tie-broken with leaf indices so
     duplicate codes are handled)
  4. node AABBs via a doubling sparse table of range-min/max over the
     sorted leaf boxes — O(T log T), single deterministic pass, no
     fixpoint iteration and no scatter contention

Layout is traversal-first: each internal node stores BOTH children's AABBs
(one [12]-wide gather fetches everything a traversal step needs) and child
links, with leaves encoded as negative ids. Triangle geometry is re-ordered
into leaf order so leaf gathers are coherent.

The single-geometry design intentionally flattens the reference's
BLAS-with-103-geometries: geometry identity (gl_GeometryIndexEXT) is
recovered from the triangle id via the per-triangle submesh table
(scene/flatten.py), which is cheaper than two-level traversal for a
1-instance scene. The per-frame instance transform is applied above this
build (wavefront/engine.rebuild_backend transforms, then rebuilds).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    """Count leading zeros of nonneg int32 (smear + popcount)."""
    x = x.astype(jnp.int32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - lax.population_count(x)


def _expand_bits10(v: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits so there are 2 zero bits between each (Morton helper)."""
    v = v.astype(jnp.int32)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton30(points: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes for points normalized into [lo, hi]."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((points - lo) / extent * 1024.0, 0.0, 1023.0).astype(jnp.int32)
    return (_expand_bits10(q[:, 0]) << 2) | (_expand_bits10(q[:, 1]) << 1) | _expand_bits10(q[:, 2])


class BVH2(NamedTuple):
    """Binary LBVH in traversal-first layout. NI = T-1 internal nodes."""

    boxes: jax.Array     # f32[NI,12] = [lmin, lmax, rmin, rmax]
    kids: jax.Array      # i32[NI,2] — >=0: internal node id; <0: leaf slot -(k+1)
    tri_v0: jax.Array    # f32[T,3] — leaf-ordered
    tri_e1: jax.Array    # f32[T,3]
    tri_e2: jax.Array    # f32[T,3]
    leaf_tri: jax.Array  # i32[T] — leaf slot → original triangle id

    @property
    def num_tris(self) -> int:
        return int(self.tri_v0.shape[0])


def build_lbvh(v0: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray) -> BVH2:
    """Build an LBVH over triangles given (v0, e1, e2). Fully jittable."""
    T = v0.shape[0]
    assert T >= 2, "LBVH needs at least 2 triangles"
    NI = T - 1

    # --- 1. Morton codes over triangle centroids --------------------------
    centroid = v0 + (e1 + e2) / 3.0
    lo = jnp.min(centroid, axis=0)
    hi = jnp.max(centroid, axis=0)
    codes = morton30(centroid, lo, hi)

    # --- 2. sort ----------------------------------------------------------
    order = jnp.argsort(codes)          # stable → deterministic with dups
    sc = codes[order]

    sv0, se1, se2 = v0[order], e1[order], e2[order]

    # --- 3. Karras internal-node topology ---------------------------------
    def delta(i, j):
        # longest-common-prefix of sorted codes; ties broken by leaf index
        # (equivalent to appending the index bits to the key)
        valid = (j >= 0) & (j < T)
        jc = jnp.clip(j, 0, T - 1)
        x = sc[i] ^ sc[jc]
        d = jnp.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return jnp.where(valid, d, -1)

    i = jnp.arange(NI, dtype=jnp.int32)
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    dmin = delta(i, i - d)

    # upper bound for range length: doubling search
    lmax = jnp.full(NI, 2, dtype=jnp.int32)
    grow = jnp.ones(NI, dtype=jnp.bool_)
    for _ in range(21):  # 2^21 > 2 * max T
        cond = grow & (delta(i, i + lmax * d) > dmin)
        lmax = jnp.where(cond, lmax * 2, lmax)
        grow = cond
    # binary refine of the exact range length l
    l = jnp.zeros(NI, dtype=jnp.int32)
    t = lmax >> 1
    for _ in range(21):
        cond = (t >= 1) & (delta(i, (l + t) * d + i) > dmin)
        l = jnp.where(cond, l + t, l)
        t = t >> 1
    j = i + l * d

    # split position: highest s with delta(i, i+(s+t)d) > delta(i,j)
    dnode = delta(i, j)
    s = jnp.zeros(NI, dtype=jnp.int32)
    t = (l + 1) >> 1
    for _ in range(21):
        cond = (t >= 1) & (delta(i, (s + t) * d + i) > dnode)
        s = jnp.where(cond, s + t, s)
        t = jnp.where(t == 1, 0, (t + 1) >> 1)
    gamma = i + s * d + jnp.minimum(d, 0)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left_is_leaf = first == gamma
    right_is_leaf = last == gamma + 1
    left = jnp.where(left_is_leaf, -(gamma + 1), gamma)
    right = jnp.where(right_is_leaf, -(gamma + 2), gamma + 1)
    kids = jnp.stack([left, right], axis=1).astype(jnp.int32)

    # --- 4. AABBs via sparse range-min/max table over sorted leaf boxes ---
    leaf_min = jnp.minimum(jnp.minimum(sv0, sv0 + se1), sv0 + se2)
    leaf_max = jnp.maximum(jnp.maximum(sv0, sv0 + se1), sv0 + se2)

    n_levels = max(1, (T - 1).bit_length())
    mins = [leaf_min]
    maxs = [leaf_max]
    for k in range(1, n_levels + 1):
        half = 1 << (k - 1)
        prev_min, prev_max = mins[-1], maxs[-1]
        idx2 = jnp.minimum(jnp.arange(T) + half, T - 1)
        mins.append(jnp.minimum(prev_min, prev_min[idx2]))
        maxs.append(jnp.maximum(prev_max, prev_max[idx2]))
    table_min = jnp.stack(mins)   # [K+1, T, 3]
    table_max = jnp.stack(maxs)

    def range_box(first_, last_):
        length = last_ - first_ + 1
        k = 31 - _clz32(length)                      # floor(log2(len))
        second = last_ - (1 << k) + 1
        bmin = jnp.minimum(table_min[k, first_], table_min[k, second])
        bmax = jnp.maximum(table_max[k, first_], table_max[k, second])
        return bmin, bmax

    # left child covers [first, gamma]; right child covers [gamma+1, last]
    lmin_box, lmax_box = range_box(first, gamma)
    rmin_box, rmax_box = range_box(gamma + 1, last)

    boxes = jnp.concatenate([lmin_box, lmax_box, rmin_box, rmax_box], axis=1)

    return BVH2(boxes=boxes.astype(jnp.float32), kids=kids,
                tri_v0=sv0, tri_e1=se1, tri_e2=se2,
                leaf_tri=order.astype(jnp.int32))
