"""BVH traversal — the device hot loop (replaces the GPU's RT cores).

Explicitly batched short-stack depth-first traversal over the LBVH2: the
whole ray wavefront advances in lock-step through ONE `lax.while_loop`
whose state is struct-of-arrays over rays ([B] nodes, [B,D] stacks, [B]
best-hit records). This hand-vectorized form — rather than `jax.vmap` of a
scalar traversal — keeps every memory access an explicit gather/scatter
([B]-indexed rows of the node/triangle tables), which XLA lowers to real
gathers instead of batching rules that can broadcast the scene per ray.

Per iteration, per ray:
  * fetch one internal node: both children's AABBs + links in a single
    [12]+[2]-wide gather (layout from accel/lbvh.py),
  * leaf children are intersected inline (Möller–Trumbore), never pushed,
  * internal children that pass the slab test: nearest followed directly,
    farther pushed — the stack only ever holds far children.
Finished rays idle (masked) until the whole dispatch converges; the
engine passes whole wavefronts in screen-tile order (wavefront/engine.py).

Two variants mirror the reference's two trace flavors:
  trace_closest  — closest-hit (primary/reflection rays, shader.rgen:51-62)
  trace_occluded — terminate-on-first-hit occlusion (shadow rays,
                   shader.rchit:113-116 ray flags)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from vkrt_jax.accel.lbvh import BVH2
from vkrt_jax.rt.intersect import DET_EPS, safe_inv_dir

# Worst-case LBVH depth: 30 levels from the 30-bit Morton hierarchy plus
# log2(max duplicate run) from index tie-breaks (accel/lbvh.py) — 64 covers
# duplicate runs up to 2^34 leaves, i.e. any representable scene. Push/pop
# below still clamp consistently (pushes past the top drop the DEEPEST far
# child rather than corrupting the stack) so an overflow could only cause
# a conservative miss, never garbage pops — and at 64 it is unreachable.
STACK_DEPTH = 64


def _traverse_block(bvh: BVH2, origins, dirs, tmin, tmax, occlusion: bool):
    """Batched traversal. origins/dirs [B,3], tmax [B]. Returns best tuple."""
    B = origins.shape[0]
    inv_d = safe_inv_dir(dirs)
    rows = jnp.arange(B, dtype=jnp.int32)

    def slab(bmin, bmax, limit):
        t0 = (bmin - origins) * inv_d
        t1 = (bmax - origins) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit = (tn <= tf) & (tf >= tmin) & (tn <= limit)
        return tn, hit

    def intersect(slot, active, t_best, slot_best, u_best, v_best):
        """Möller–Trumbore against per-ray triangle `slot` ([B])."""
        sv = jnp.maximum(slot, 0)
        v0 = bvh.tri_v0[sv]
        e1 = bvh.tri_e1[sv]
        e2 = bvh.tri_e2[sv]
        h = jnp.cross(dirs, e2)
        det = jnp.sum(e1 * h, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > DET_EPS,
                            1.0 / jnp.where(det == 0, 1.0, det), 0.0)
        s = origins - v0
        u = jnp.sum(s * h, axis=-1) * inv_det
        q = jnp.cross(s, e1)
        v = jnp.sum(dirs * q, axis=-1) * inv_det
        t = jnp.sum(e2 * q, axis=-1) * inv_det
        ok = (active & (jnp.abs(det) > DET_EPS) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > tmin) & (t < t_best))
        return (jnp.where(ok, t, t_best),
                jnp.where(ok, slot, slot_best),
                jnp.where(ok, u, u_best),
                jnp.where(ok, v, v_best))

    def body(state):
        node, stack, sp, t_best, slot_best, u_best, v_best, finished, it = state

        box = bvh.boxes[node]          # [B,12]
        kid = bvh.kids[node]           # [B,2]
        limit = jnp.minimum(tmax, t_best)

        tl, hit_l = slab(box[:, 0:3], box[:, 3:6], limit)
        tr, hit_r = slab(box[:, 6:9], box[:, 9:12], limit)
        hit_l = hit_l & ~finished
        hit_r = hit_r & ~finished

        leaf_l = kid[:, 0] < 0
        leaf_r = kid[:, 1] < 0

        # inline leaf intersections (masked)
        t_best, slot_best, u_best, v_best = intersect(
            -kid[:, 0] - 1, hit_l & leaf_l, t_best, slot_best, u_best, v_best)
        t_best, slot_best, u_best, v_best = intersect(
            -kid[:, 1] - 1, hit_r & leaf_r, t_best, slot_best, u_best, v_best)
        if occlusion:
            finished = finished | (slot_best >= 0)

        go_l = hit_l & ~leaf_l
        go_r = hit_r & ~leaf_r
        both = go_l & go_r
        near_is_l = tl <= tr
        near = jnp.where(near_is_l, kid[:, 0], kid[:, 1])
        far = jnp.where(near_is_l, kid[:, 1], kid[:, 0])
        one = jnp.where(go_l, kid[:, 0], kid[:, 1])

        # push far child where both internal children hit; a full stack
        # drops the push (and does NOT advance sp), keeping push/pop
        # consistent — see STACK_DEPTH note above
        push_ok = both & ~finished & (sp < STACK_DEPTH)
        pushed = stack.at[rows, sp].set(far, mode="drop")
        stack = jnp.where(push_ok[:, None], pushed, stack)
        sp = sp + push_ok.astype(jnp.int32)

        need_pop = ~(go_l | go_r) | finished
        popped_sp = jnp.maximum(sp - 1, 0)
        popped = stack[rows, popped_sp]
        newly_done = need_pop & (sp == 0)
        finished = finished | newly_done
        node = jnp.where(finished, 0,
                         jnp.where(need_pop, popped,
                                   jnp.where(both, near, one)))
        sp = jnp.where(need_pop & ~finished, popped_sp, sp)
        return node, stack, sp, t_best, slot_best, u_best, v_best, finished, it + 1

    def cond(state):
        return ~jnp.all(state[7])

    state0 = (
        jnp.zeros(B, dtype=jnp.int32),                 # node (root)
        jnp.zeros((B, STACK_DEPTH), dtype=jnp.int32),  # stack
        jnp.zeros(B, dtype=jnp.int32),                 # sp
        jnp.asarray(tmax, dtype=jnp.float32),          # t_best
        jnp.full(B, -1, dtype=jnp.int32),              # slot_best
        jnp.zeros(B, dtype=jnp.float32),               # u
        jnp.zeros(B, dtype=jnp.float32),               # v
        jnp.zeros(B, dtype=jnp.bool_),                 # finished
        jnp.int32(0),                                  # iteration counter
    )
    out = lax.while_loop(cond, body, state0)
    return out[3], out[4], out[5], out[6], out[8]


@jax.jit
def trace_closest(bvh: BVH2, origins, dirs, tmin, tmax):
    """Closest-hit trace. Returns (t, tri_id, u, v); tri_id=-1 on miss.

    tri_id is in ORIGINAL triangle numbering (leaf slots resolved through
    bvh.leaf_tri), ready for the scene's per-triangle material tables.
    """
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), origins.shape[:1])
    t, slot, u, v, _ = _traverse_block(bvh, origins, dirs, tmin, tmax_arr, False)
    tri = jnp.where(slot >= 0, bvh.leaf_tri[jnp.maximum(slot, 0)], -1)
    return t, tri, u, v


@jax.jit
def trace_closest_stats(bvh: BVH2, origins, dirs, tmin, tmax):
    """trace_closest + lock-step loop iteration count (divergence metric,
    the analogue of mean-nodes-visited counters from SURVEY.md §7 risk b)."""
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), origins.shape[:1])
    t, slot, u, v, iters = _traverse_block(bvh, origins, dirs, tmin, tmax_arr, False)
    tri = jnp.where(slot >= 0, bvh.leaf_tri[jnp.maximum(slot, 0)], -1)
    return t, tri, u, v, iters


@jax.jit
def trace_occluded(bvh: BVH2, origins, dirs, tmin, tmax):
    """Any-hit occlusion trace. Returns bool[B] (True = blocked)."""
    tmax_arr = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), origins.shape[:1])
    _, slot, _, _, _ = _traverse_block(bvh, origins, dirs, tmin, tmax_arr, True)
    return slot >= 0
