"""CPU golden-image oracle: brute-force reference path tracer (numpy).

The reference validates frames only by eye against a screenshot
(SURVEY.md §4); BASELINE.json instead prescribes a golden-image harness.
Since no Vulkan GPU exists in this environment, this module IS the golden
source: an *independent*, deliberately brute-force (no BVH — every ray
tests every triangle) implementation of the full behavioral contract:

  ray gen           ref: shaders/shader.rgen:30-77
  closest-hit shade ref: shaders/shader.rchit:86-172
  miss              ref: shaders/shader.rmiss:15-18
  bounce loop       ref: shaders/shader.rgen:40-74 (maxDepth, attenuation)

Every constant comes from vkrt_jax.config (the golden table in SURVEY.md §7).
Intentional deviation, documented: zero-length vectors are safe-normalized
(GLSL normalize(vec3(0)) is undefined/NaN; one Sponza primitive has no
TANGENT attribute and would poison comparisons).
"""

from __future__ import annotations

import numpy as np

from vkrt_jax import config as C
from vkrt_jax.scene.flatten import FlatScene
from vkrt_jax.scene.textures import TextureHeap

# Chunk sizes bound peak temp memory: the Möller–Trumbore intermediates are
# [_RAY_CHUNK, _TRI_CHUNK, 3] f32 ≈ 100MB at these settings.
_TRI_CHUNK = 1 << 14
_RAY_CHUNK = 1 << 9


def _safe_normalize(v: np.ndarray, axis: int = -1) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-20)


# ---------------------------------------------------------------------------
# Intersection (Möller–Trumbore, no culling — the reference sets no cull
# flags; both triangle faces hit)
# ---------------------------------------------------------------------------

def closest_hit(origins: np.ndarray, dirs: np.ndarray, tmin: float,
                tmax: np.ndarray | float, v0: np.ndarray, e1: np.ndarray,
                e2: np.ndarray):
    """Brute-force closest hit. Returns (t, tri_index, u, v); tri=-1 on miss."""
    n_rays = origins.shape[0]
    best_t = np.full(n_rays, np.inf, dtype=np.float32)
    best_tri = np.full(n_rays, -1, dtype=np.int64)
    best_u = np.zeros(n_rays, dtype=np.float32)
    best_v = np.zeros(n_rays, dtype=np.float32)
    tmax_arr = np.broadcast_to(np.asarray(tmax, dtype=np.float32), (n_rays,))

    for r0 in range(0, n_rays, _RAY_CHUNK):
        r1 = min(r0 + _RAY_CHUNK, n_rays)
        o = origins[r0:r1, None, :]
        d = dirs[r0:r1, None, :]
        for t0 in range(0, v0.shape[0], _TRI_CHUNK):
            t1 = min(t0 + _TRI_CHUNK, v0.shape[0])
            h = np.cross(d, e2[None, t0:t1])
            det = np.sum(e1[None, t0:t1] * h, axis=-1)
            inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
            s = o - v0[None, t0:t1]
            u = np.sum(s * h, axis=-1) * inv_det
            q = np.cross(s, e1[None, t0:t1])
            v = np.sum(d * q, axis=-1) * inv_det
            t = np.sum(e2[None, t0:t1] * q, axis=-1) * inv_det
            valid = ((np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
                     & (t > tmin) & (t < tmax_arr[r0:r1, None]))
            t = np.where(valid, t, np.inf)
            arg = np.argmin(t, axis=1)
            rows = np.arange(r1 - r0)
            tmin_chunk = t[rows, arg]
            better = tmin_chunk < best_t[r0:r1]
            best_t[r0:r1] = np.where(better, tmin_chunk, best_t[r0:r1])
            best_tri[r0:r1] = np.where(better, arg + t0, best_tri[r0:r1])
            best_u[r0:r1] = np.where(better, u[rows, arg], best_u[r0:r1])
            best_v[r0:r1] = np.where(better, v[rows, arg], best_v[r0:r1])
    return best_t, best_tri, best_u, best_v


def occluded(origins: np.ndarray, dirs: np.ndarray, tmin: float,
             tmax: np.ndarray, v0: np.ndarray, e1: np.ndarray,
             e2: np.ndarray) -> np.ndarray:
    """Any-hit occlusion test (shadow rays, ref: shader.rchit:113-116 flags)."""
    n_rays = origins.shape[0]
    hit = np.zeros(n_rays, dtype=bool)
    for r0 in range(0, n_rays, _RAY_CHUNK):
        r1 = min(r0 + _RAY_CHUNK, n_rays)
        o = origins[r0:r1, None, :]
        d = dirs[r0:r1, None, :]
        blocked = np.zeros(r1 - r0, dtype=bool)
        for t0 in range(0, v0.shape[0], _TRI_CHUNK):
            t1 = min(t0 + _TRI_CHUNK, v0.shape[0])
            h = np.cross(d, e2[None, t0:t1])
            det = np.sum(e1[None, t0:t1] * h, axis=-1)
            inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
            s = o - v0[None, t0:t1]
            u = np.sum(s * h, axis=-1) * inv_det
            q = np.cross(s, e1[None, t0:t1])
            v = np.sum(d * q, axis=-1) * inv_det
            t = np.sum(e2[None, t0:t1] * q, axis=-1) * inv_det
            valid = ((np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
                     & (t > tmin) & (t < tmax[r0:r1, None]))
            blocked |= valid.any(axis=1)
        hit[r0:r1] = blocked
    return hit


# ---------------------------------------------------------------------------
# Texture sampling — bilinear, repeat wrap, lod 0
# (sampler config ref: src/Raytracer.cpp:436-458; `texture()` in a
# ray-tracing stage has no derivatives → base level)
# ---------------------------------------------------------------------------

def sample_texture(heap: TextureHeap, tex_ids: np.ndarray, uv: np.ndarray) -> np.ndarray:
    offset = heap.level_offset[tex_ids, 0].astype(np.int64)
    w = heap.level_width[tex_ids, 0].astype(np.int64)
    h = heap.level_height[tex_ids, 0].astype(np.int64)

    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0).astype(np.float32)[:, None]
    fy = (y - y0).astype(np.float32)[:, None]

    def texel(xi, yi):
        xi = np.mod(xi, w)
        yi = np.mod(yi, h)
        return heap.texels[offset + yi * w + xi].astype(np.float32) / 255.0

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


# ---------------------------------------------------------------------------
# Ray generation (ref: shaders/shader.rgen:30-38)
# ---------------------------------------------------------------------------

def generate_camera_rays(width: int, height: int, proj_inverse: np.ndarray,
                         view_inverse: np.ndarray):
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, ys)  # [H,W]
    uvn = np.stack([gx, gy, np.ones_like(gx), np.ones_like(gx)], axis=-1)
    target = uvn @ proj_inverse.T
    d_view = _safe_normalize(target[..., :3])
    d4 = np.concatenate([d_view, np.zeros_like(d_view[..., :1])], axis=-1)
    dirs = (d4 @ view_inverse.T)[..., :3]
    origin = (view_inverse @ np.array([0, 0, 0, 1], dtype=np.float32))[:3]
    origins = np.broadcast_to(origin, dirs.shape).copy()
    return origins.reshape(-1, 3).astype(np.float32), dirs.reshape(-1, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# Full-frame render: the rgen bounce loop + rchit shading, vectorized
# ---------------------------------------------------------------------------

# Stability-margin defaults (native/tracer.cpp intersect_tri_margin):
#   mu/mt  — base arithmetic slack of the intersection math itself
#   deps   — relative direction error between two independent raygen
#            implementations for PRIMARY rays and shadow directions
#            (a few f32 ulps through normalize chains)
#   oeps0  — world-space origin error of depth-0 shadow rays (the
#            interpolated hit point; ~1e-5 on stability-certified hits)
#   deps1  — direction error of depth>=1 rays: reflected directions go
#            through a normal-map SAMPLE + TBN chain, so two correct
#            tracers diverge by ~1e-4..1e-3 (fixed 5e-7 margins left
#            reflection-path flips on certified pixels)
#   oeps1  — origin error of depth>=1 rays / their shadow rays
STABLE_MARGINS = dict(mu=2e-5, mt=1e-5, deps=5e-7, oeps0=1e-5,
                      deps1=3e-4, oeps1=1e-4)


def render_golden(flat: FlatScene, heap: TextureHeap, proj_inverse: np.ndarray,
                  view_inverse: np.ndarray, cfg: C.RenderConfig,
                  accel: str = "brute", with_stable: bool = False,
                  stable_margins: dict | None = None):
    """Render one frame; returns f32[H,W,3] linear color (unclamped).

    accel="brute" tests every ray against every triangle (the maximally
    independent oracle); accel="native" routes intersection through the
    C++ BVH tracer (vkrt_jax/native) — ~100x faster, still independent of
    the JAX device paths — for larger golden frames.

    with_stable=True (native only) additionally returns a bool[H,W]
    STABILITY mask: True where the oracle certifies that any correct f32
    tracer must reproduce this pixel (no traced ray at any depth passes
    within float-rounding margins of an acceptance boundary — triangle
    edges, t windows, near-tie commits, the metallic-reflection
    threshold). The golden gate demands raw-RMSE conformance on the
    certified set; the excluded pixels are ORACLE-identified a priori,
    never observed-diff trimming (see native/tracer.cpp "Stability
    classification")."""
    idx = flat.indices.astype(np.int64)
    v0 = flat.positions[idx[:, 0]]
    e1 = flat.positions[idx[:, 1]] - v0
    e2 = flat.positions[idx[:, 2]] - v0

    closest_fn, occluded_fn = closest_hit, occluded
    if accel == "native":
        from vkrt_jax.native import NativeBVH
        bvh = NativeBVH(v0, e1, e2)
        if with_stable:
            sm = dict(STABLE_MARGINS)
            sm.update(stable_margins or {})
            closest_fn = lambda o, d, tmin, tmax, *_, deps=None, oeps=0.0: \
                bvh.closest_stable(o, d, tmin, tmax, mu=sm["mu"],
                                   mt=sm["mt"],
                                   deps=sm["deps"] if deps is None else deps,
                                   oeps=oeps)
            occluded_fn = lambda o, d, tmin, tmax, *_, deps=None, oeps=0.0: \
                bvh.occluded_stable(o, d, tmin, tmax, mu=sm["mu"],
                                    mt=sm["mt"],
                                    deps=sm["deps"] if deps is None else deps,
                                    oeps=oeps)
        else:
            closest_fn = lambda o, d, tmin, tmax, *_: bvh.closest(o, d, tmin,
                                                                  tmax)
            occluded_fn = lambda o, d, tmin, tmax, *_: bvh.occluded(o, d,
                                                                    tmin, tmax)
    elif with_stable:
        raise ValueError("with_stable requires accel='native'")

    origins, dirs = generate_camera_rays(cfg.width, cfg.height,
                                         proj_inverse, view_inverse)
    n = origins.shape[0]
    accum = np.zeros((n, 3), dtype=np.float32)
    attenuation = np.ones(n, dtype=np.float32)
    active = np.ones(n, dtype=bool)
    stable_px = np.ones(n, dtype=bool)
    lights = C.LIGHT_POSITIONS[:cfg.num_lights]

    for depth in range(cfg.max_depth):
        if not active.any():
            break
        ao = origins[active]
        ad = dirs[active]
        if with_stable:
            oe = 0.0 if depth == 0 else sm["oeps1"]
            de = None if depth == 0 else sm["deps1"]
            t, tri, hu, hv, c_stable = closest_fn(ao, ad, C.RAY_TMIN,
                                                  C.RAY_TMAX, v0, e1, e2,
                                                  deps=de, oeps=oe)
            idxs = np.flatnonzero(active)
            stable_px[idxs[~c_stable]] = False
        else:
            t, tri, hu, hv = closest_fn(ao, ad, C.RAY_TMIN, C.RAY_TMAX,
                                        v0, e1, e2)
        hit = tri >= 0

        # --- miss: sky, ray done (ref: shader.rmiss:17 — note: sky is NOT
        # attenuated; the miss shader overwrites hitValue unconditionally)
        contrib = np.zeros((ao.shape[0], 3), dtype=np.float32)
        contrib[~hit] = C.SKY_COLOR

        if hit.any():
            h_tri = tri[hit]
            h_u = hu[hit][:, None]
            h_v = hv[hit][:, None]
            h_w = 1.0 - h_u - h_v
            vi = idx[h_tri]

            pos = (flat.positions[vi[:, 0]] * h_w + flat.positions[vi[:, 1]] * h_u
                   + flat.positions[vi[:, 2]] * h_v)
            nrm = (flat.normals[vi[:, 0]] * h_w + flat.normals[vi[:, 1]] * h_u
                   + flat.normals[vi[:, 2]] * h_v)
            uv = (flat.uvs[vi[:, 0]] * h_w + flat.uvs[vi[:, 1]] * h_u
                  + flat.uvs[vi[:, 2]] * h_v)
            tan = (flat.tangents[vi[:, 0], :3] * h_w + flat.tangents[vi[:, 1], :3] * h_u
                   + flat.tangents[vi[:, 2], :3] * h_v)

            world_n = _safe_normalize(nrm)
            base_ids = flat.tri_base_color[h_tri]
            base_color = sample_texture(heap, base_ids, uv)[:, :3]

            if cfg.flat_albedo:
                contrib[hit] = base_color
                still = np.zeros(ao.shape[0], dtype=bool)
            else:
                # TBN normal mapping (ref: shader.rchit:78-84,105-108;
                # tangent.w handedness unused — quirk preserved)
                T = _safe_normalize(tan)
                B = np.cross(T, world_n)
                nm_ids = flat.tri_normal[h_tri]
                map_n = sample_texture(heap, nm_ids, uv)[:, :3] * 2.0 - 1.0
                map_n = _safe_normalize(map_n)
                pert_n = _safe_normalize(T * map_n[:, 0:1] + B * map_n[:, 1:2]
                                         + world_n * map_n[:, 2:3])

                total_light = np.zeros(pos.shape[0], dtype=np.float32)
                for li in range(len(lights)):
                    lvec = lights[li] - pos
                    ldist = np.linalg.norm(lvec, axis=1)
                    ldir = lvec / np.maximum(ldist[:, None], 1e-20)
                    ndotl = np.sum(pert_n * ldir, axis=1)
                    diffuse = np.clip(ndotl, 0.0, 1.0)
                    power = C.LIGHT_INTENSITY / np.maximum(ldist * ldist, 1e-20)
                    mult = np.ones_like(diffuse)
                    if cfg.enable_shadows:
                        cast = ndotl > 0
                        if cast.any():
                            if with_stable:
                                sh, s_stable = occluded_fn(
                                    pos[cast], ldir[cast], C.RAY_TMIN,
                                    ldist[cast], v0, e1, e2,
                                    oeps=sm["oeps0"] if depth == 0
                                    else sm["oeps1"])
                                act_i = np.flatnonzero(active)
                                hit_i = act_i[hit]
                                stable_px[hit_i[np.flatnonzero(cast)[
                                    ~s_stable]]] = False
                            else:
                                sh = occluded_fn(pos[cast], ldir[cast],
                                                 C.RAY_TMIN, ldist[cast],
                                                 v0, e1, e2)
                            m = np.ones(cast.sum(), dtype=np.float32)
                            m[sh] = C.SHADOW_MULTIPLIER
                            mult[cast] = m
                    total_light += diffuse * power * mult

                att = attenuation[active][hit]
                hit_value = (base_color * total_light[:, None] * att[:, None]
                             + base_color * C.AMBIENT)

                # Reflection (ref: shader.rchit:161-171) — attenuation is
                # updated BEFORE hitValue is scaled by (1 - attenuation).
                mr_ids = flat.tri_metallic_roughness[h_tri]
                metallic = sample_texture(heap, mr_ids, uv)[:, 2]
                reflective = cfg.enable_reflections & (metallic > C.METALLIC_THRESHOLD)
                if with_stable and cfg.enable_reflections:
                    # the metallic>threshold branch flips the whole pixel's
                    # shading path; sampled metallic within 1e-3 of the
                    # threshold is not certifiable across tracers
                    marginal = np.abs(metallic - C.METALLIC_THRESHOLD) < 1e-3
                    act_i = np.flatnonzero(active)
                    stable_px[act_i[hit][marginal]] = False
                new_att = att * (C.REFLECT_SCALE * metallic)
                att_out = np.where(reflective, new_att, att)
                hit_value = np.where(reflective[:, None],
                                     hit_value * (1.0 - att_out[:, None]),
                                     hit_value)
                contrib[hit] = hit_value

                # update carried rays
                refl_dir = ad[hit] - 2.0 * np.sum(ad[hit] * pert_n, axis=1,
                                                  keepdims=True) * pert_n
                act_idx = np.flatnonzero(active)
                hit_idx = act_idx[hit]
                origins[hit_idx] = pos
                dirs[hit_idx] = np.where(reflective[:, None], refl_dir, dirs[hit_idx])
                attenuation[hit_idx] = att_out
                still = np.zeros(ao.shape[0], dtype=bool)
                still[np.flatnonzero(hit)] = reflective

        else:
            still = np.zeros(ao.shape[0], dtype=bool)

        accum[active] += contrib
        new_active = np.zeros(n, dtype=bool)
        new_active[np.flatnonzero(active)[still]] = True
        active = new_active

    img = accum.reshape(cfg.height, cfg.width, 3)
    if with_stable:
        return img, stable_px.reshape(cfg.height, cfg.width)
    return img
