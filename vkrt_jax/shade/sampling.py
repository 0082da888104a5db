"""Texture sampling — bilinear / repeat-wrap over the quad-texel heap.

Implements the reference sampler's semantics (linear min/mag, repeat UVW,
no anisotropy — ref: src/Raytracer.cpp:436-458). `texture()` in a
ray-tracing stage has no derivatives, so the reference samples the base
mip; `lod` is exposed for completeness (mip chains are built by
scene/textures.py, matching the blit loop at src/Raytracer.cpp:572-640).

Storage: the heap stores, for every texel, its full bilinear 2x2 quads
with repeat wrap pre-applied (scene/textures.py), so one gather per
sample fetches the whole footprint (one wide row instead of four narrow
ones, at 4x memory). Whether that trade pays on the GPU is not
measured.

Lane-major interface: tex_ids [Nb,128], uv [2,Nb,128] → rgba [4,Nb,128].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_material(texels_tri, level_offset, level_width, level_height,
                    slot_ids, uv, lod: int = 0):
    """One gather per ray fetches the bilinear footprints of ALL THREE of
    a material's maps (base color, metallic-roughness, normal) from the
    packed 48-byte material heap (scene/textures.py build_material_heap).
    The three maps of a slot are co-sized, so index/weight math is
    computed once. Returns (base, mr, normal) each [4,Nb,128]."""
    off = level_offset[slot_ids, lod]
    w = level_width[slot_ids, lod]
    h = level_height[slot_ids, lod]

    x = uv[0] * w - 0.5
    y = uv[1] * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0

    xi = jnp.mod(x0, w)
    yi = jnp.mod(y0, h)
    rows = texels_tri[off + yi * w + xi]     # [Nb,128,48] u8 — ONE gather
    q = rows.astype(jnp.float32) / 255.0
    w00 = ((1 - fx) * (1 - fy))[..., None]
    w10 = (fx * (1 - fy))[..., None]
    w01 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]

    def lerp(base):
        rgba = (q[..., base + 0:base + 4] * w00
                + q[..., base + 4:base + 8] * w10
                + q[..., base + 8:base + 12] * w01
                + q[..., base + 12:base + 16] * w11)
        return jnp.moveaxis(rgba, -1, 0)     # [4,Nb,128]

    return lerp(0), lerp(16), lerp(32)


def sample_material_trilinear(texels_tri, level_offset, level_width,
                              level_height, slot_ids, uv, lod_f):
    """Per-ray mip LOD (trilinear filtering): two quad-heap gathers at
    the bracketing levels + a linear blend. BEYOND-PARITY feature — the
    reference's ray-tracing stage has no derivatives and always samples
    level 0 (`texture()` in shader.rchit; sampler chain built but unused
    past lod 0) — so this is off by default (config.mip_lod) and never
    on in golden-gated paths. lod_f: f32[Nb,128] (clamped to the chain).
    Costs exactly 2x the lod-0 sampler (gather cost is per-row)."""
    levels = level_offset.shape[1]
    l0 = jnp.clip(jnp.floor(lod_f).astype(jnp.int32), 0, levels - 1)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    f = jnp.clip(lod_f - l0.astype(jnp.float32), 0.0, 1.0)[None]
    lo = sample_material(texels_tri, level_offset, level_width,
                         level_height, slot_ids, uv, lod=l0)
    hi = sample_material(texels_tri, level_offset, level_width,
                         level_height, slot_ids, uv, lod=l1)
    return tuple(a * (1.0 - f) + b * f for a, b in zip(lo, hi))


def ray_diff_lod(uv, hit, mat_ids, level_width, level_height, slot_ids):
    """Screen-space mip LOD from wavefront-neighbor differentials.

    The engine's lane layout packs an 8x16 pixel subtile per 128-lane
    group (wavefront.engine.tile), so the +x neighbor is lane+1 and the
    +y neighbor lane+16: uv finite differences across lanes are the
    rgen-stage analogue of fragment-shader derivatives (which the
    reference's RT stage cannot have). The standard GL rho formula
    gives lod = log2(max texel footprint); differences across surface
    boundaries (different triangle material, or a miss) clamp to 0 so
    edges stay sharp."""
    w0 = level_width[slot_ids, 0].astype(jnp.float32)
    h0 = level_height[slot_ids, 0].astype(jnp.float32)
    lane = jnp.arange(128, dtype=jnp.int32)

    def diff(a, shift, use_fwd):
        # backward difference, except at subtile-wrap lanes (a +1 roll
        # makes lane 0's "neighbor" lane 127 — 8 pixel rows away) where
        # the forward difference is the in-subtile neighbor
        back = a - jnp.roll(a, shift, axis=-1)
        fwd = jnp.roll(a, -shift, axis=-1) - a
        return jnp.where(use_fwd, fwd, back)

    def nbr_ok(shift, use_fwd):
        def ok(roll_s):
            return hit & jnp.roll(hit, roll_s, axis=-1) \
                & (mat_ids == jnp.roll(mat_ids, roll_s, axis=-1))
        return jnp.where(use_fwd, ok(-shift), ok(shift))

    fwd_x = (lane % 16) == 0          # 8x16 subtile: +x neighbor = lane+1
    fwd_y = lane < 16                 # +y neighbor = lane+16
    dx = [diff(uv[0], 1, fwd_x) * w0, diff(uv[1], 1, fwd_x) * h0]
    dy = [diff(uv[0], 16, fwd_y) * w0, diff(uv[1], 16, fwd_y) * h0]
    rho_x = jnp.sqrt(dx[0] ** 2 + dx[1] ** 2)
    rho_y = jnp.sqrt(dy[0] ** 2 + dy[1] ** 2)
    rho = jnp.maximum(jnp.where(nbr_ok(1, fwd_x), rho_x, 1.0),
                      jnp.where(nbr_ok(16, fwd_y), rho_y, 1.0))
    return jnp.maximum(jnp.log2(jnp.maximum(rho, 1.0)), 0.0)


def sample_material_compact(texels_tri, level_offset, level_width,
                            level_height, slot_ids, uv, live,
                            cap_rows: int, lod: int = 0):
    """sample_material over only the 128-lane ROWS with any live lane.

    Gather cost grows with the lanes gathered, so sparse wavefronts
    (the depth>=1 rounds) would pay full price under the plain sampler.
    Here live rows are packed to the front (stable argsort of the
    row-liveness bits) and sampled in `cap_rows` chunks inside a
    while_loop — trip count ceil(live_rows/cap_rows), so the result is
    exact for ANY liveness.
    Dead rows return zeros. Returns (base, mr, normal) each [4,Nb,128]."""
    nb = slot_ids.shape[0]
    assert 0 < cap_rows <= nb, f"cap_rows {cap_rows} vs {nb} rows"
    glive = jnp.any(live, axis=1)
    perm = jnp.argsort(~glive, stable=True)
    inv = jnp.argsort(perm, stable=True)
    cnt = jnp.sum(glive.astype(jnp.int32))
    sid_p = jnp.where(live, slot_ids, 0)[perm]
    uv_p = jnp.where(live[None], uv, 0.0)[:, perm]

    out0 = jnp.zeros((12, nb, 128), jnp.float32)

    def cond(state):
        k, _ = state
        return k * cap_rows < cnt

    def body(state):
        k, acc = state
        s_chunk = jax.lax.dynamic_slice(sid_p, (k * cap_rows, 0),
                                        (cap_rows, 128))
        u_chunk = jax.lax.dynamic_slice(uv_p, (0, k * cap_rows, 0),
                                        (2, cap_rows, 128))
        a, b, c = sample_material(texels_tri, level_offset, level_width,
                                  level_height, s_chunk, u_chunk, lod=lod)
        chunk = jnp.concatenate([a, b, c], axis=0)
        acc = jax.lax.dynamic_update_slice(acc, chunk, (0, k * cap_rows, 0))
        return k + 1, acc

    _, out_p = jax.lax.while_loop(cond, body, (jnp.int32(0), out0))
    out = out_p[:, inv]
    return out[0:4], out[4:8], out[8:12]
