"""Depth>=1 wavefront re-tiling: stable radix-partition permutations.

Secondary dispatches (reflection closest, depth-1 shadows) are sparse
and incoherent: neighbouring rays of one dispatch point in different
directions from scattered surface points. Re-sorting live rays into
spatially coherent order makes neighbouring rays walk similar BVH
paths. Whether that pays on the GPU is not measured.

The permutation is a stable LSD radix partition over tiny keys (4-13
bits): one cumsum + one scatter per key bit, O(N). Stability matters:
within a bucket the pre-sort order is the camera-tile order, so
octant-only keys inherit origin coherence for free.

Used LOCALLY around a dispatch: permute the inputs, trace, apply the
inverse permutation to the outputs. Each ray's LBVH walk is independent
of the other rays of its dispatch, so permuted dispatches return the
same per-ray answers; shadow-only frames are asserted bit-equal and
frames with reflections allclose (atol 1e-5), which leaves room for a
compiler's different rounding of the permuted program.

Replaces the ray-sorting stage the reference's GPU scheduler performs
implicitly in hardware (warp coherence of vkCmdTraceRaysKHR,
ref: src/Raytracer.cpp:157); the north-star contract ("rays sorted by
material/direction between rounds", SURVEY.md §7 layer 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def radix_partition_perm(key: jax.Array, nbits: int) -> jax.Array:
    """Stable ascending permutation of small integer keys.

    key: i32[N] in [0, 2**nbits). Returns perm i32[N] with key[perm]
    stably sorted — nbits passes of cumsum + unique-index scatter.
    """
    n = key.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    perm = iota
    key = key.astype(jnp.int32)
    k = key
    for b in range(nbits):
        bit = jax.lax.shift_right_logical(k, b) & 1
        ones = jnp.cumsum(bit)                     # inclusive 1-count
        total0 = n - ones[-1]
        zeros = iota + 1 - ones                    # inclusive 0-count
        pos = jnp.where(bit == 0, zeros - 1, total0 + ones - 1)
        perm = jnp.zeros_like(perm).at[pos].set(perm, unique_indices=True)
        # current-order keys by GATHER from the original array (one
        # scatter per pass, not two)
        k = key[perm]
    return perm


def inverse_permutation(perm: jax.Array) -> jax.Array:
    n = perm.shape[0]
    return jnp.zeros_like(perm).at[perm].set(
        jnp.arange(n, dtype=perm.dtype), unique_indices=True)


def permute_rays(arr: jax.Array, perm: jax.Array) -> jax.Array:
    """Apply a ray permutation to a lane-major array [..., Nb, 128]."""
    flat = arr.reshape(arr.shape[:-2] + (-1,))
    return jnp.take(flat, perm, axis=-1).reshape(arr.shape)


def octant_key(d: jax.Array, live: jax.Array) -> jax.Array:
    """Direction-octant key (live rays 0-7, dead 8 → sorted to the
    tail). d [3,Nb,128],
    live bool[Nb,128] → i32[N]. 4-bit radix."""
    dx = (d[0] < 0).astype(jnp.int32)
    dy = (d[1] < 0).astype(jnp.int32)
    dz = (d[2] < 0).astype(jnp.int32)
    k = dx | (dy << 1) | (dz << 2)
    return jnp.where(live, k, 8).reshape(-1)


OCTANT_BITS = 4

CELL_BITS_PER_AXIS = 3
CELL_KEY_BITS = 3 * CELL_BITS_PER_AXIS + 1        # + dead-tail bit


def cell_key(p: jax.Array, live: jax.Array, scene_aabb: jax.Array
             ) -> jax.Array:
    """Morton cell key of a surface point (3 bits/axis within the scene
    AABB; dead rays → 512, the tail bucket). p [3,Nb,128], live
    bool[Nb,128], scene_aabb f32[2,3] (a backend field). 10-bit radix."""
    nbins = (1 << CELL_BITS_PER_AXIS) - 1
    lo = scene_aabb[0]
    span = jnp.maximum(scene_aabb[1] - scene_aabb[0], 1e-6)
    key = jnp.zeros(p.shape[1] * p.shape[2], jnp.int32)
    for a in range(3):
        q = jnp.clip((p[a].reshape(-1) - lo[a]) / span[a] * (nbins + 1),
                     0.0, float(nbins)).astype(jnp.int32)
        for b in range(CELL_BITS_PER_AXIS):
            key = key | (((q >> b) & 1) << (3 * b + a))
    return jnp.where(live.reshape(-1), key, 1 << (3 * CELL_BITS_PER_AXIS))


# ---------------------------------------------------------------------------
# GROUP (128-lane) granularity resort.
#
# Permuting whole 128-lane GROUPS (the engine's 8x16-pixel subtiles) moves
# 128x fewer rows than the ray-granular resort above: one jnp.take of
# [..., Nb, 128] along Nb. Groups keep their internal camera-tile
# coherence; sorting makes neighbouring groups have SIMILAR keys instead
# of being adjacent screen subtiles whose surface points span foreground
# and background.
# ---------------------------------------------------------------------------

GROUP_CELL_BITS_PER_AXIS = 4
GROUP_CELL_KEY_BITS = 3 * GROUP_CELL_BITS_PER_AXIS + 1   # + dead-tail bit


def group_live_mean3(p: jax.Array, live: jax.Array):
    """Per-group live-ray mean of a lane-major vector.

    p [3,Nb,128], live bool[Nb,128] → (mean f32[3,Nb], any bool[Nb])."""
    cnt = jnp.maximum(jnp.sum(live.astype(jnp.float32), axis=-1), 1.0)
    s = jnp.sum(jnp.where(live[None], p, 0.0), axis=-1)      # [3, Nb]
    return s / cnt[None], jnp.any(live, axis=-1)


def _quant_cell(mean: jax.Array, scene_aabb: jax.Array, bits: int):
    """Morton-interleave a [3,Nb] point into 3*bits-bit cells."""
    nbins = (1 << bits) - 1
    lo = scene_aabb[0]
    span = jnp.maximum(scene_aabb[1] - scene_aabb[0], 1e-6)
    key = jnp.zeros(mean.shape[1], jnp.int32)
    for a in range(3):
        q = jnp.clip((mean[a] - lo[a]) / span[a] * (nbins + 1),
                     0.0, float(nbins)).astype(jnp.int32)
        for b in range(bits):
            key = key | (((q >> b) & 1) << (3 * b + a))
    return key


def group_cell_key(p: jax.Array, live: jax.Array, scene_aabb: jax.Array
                   ) -> jax.Array:
    """Per-group Morton cell of the mean live surface point; all-dead
    groups → the tail bucket. p [3,Nb,128], live bool[Nb,128] → i32[Nb].
    GROUP_CELL_KEY_BITS-bit radix."""
    mean, anyl = group_live_mean3(p, live)
    key = _quant_cell(mean, scene_aabb, GROUP_CELL_BITS_PER_AXIS)
    return jnp.where(anyl, key, 1 << (3 * GROUP_CELL_BITS_PER_AXIS))


def permute_groups(arr: jax.Array, perm: jax.Array) -> jax.Array:
    """Apply a GROUP permutation to a lane-major array [..., Nb, 128]
    (whole 128-lane rows move; lane order inside a group is untouched)."""
    return jnp.take(arr, perm, axis=-2)
