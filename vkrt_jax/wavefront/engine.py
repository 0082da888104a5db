"""Wavefront frame engine — replaces rgen recursion + SBT dispatch.

The reference's per-pixel bounce loop with nested shadow traces
(shaders/shader.rgen:49-74, shader.rchit:119-152) becomes flat wavefront
rounds over the whole frame:

  ray gen → closest-hit trace (+ attribute gather) → shade →
  shadow occlusion traces (one batch per light) → reflection carry →
  repeat up to max_depth → framebuffer

Shader-binding-table dispatch (ref: src/Raytracer.cpp:1469-1529) reduces
to the trace-mode flag: closest-hit vs occlusion — the miss "shaders"
(sky / not-shadowed) are where-selects on the miss mask.

Per-ray state is lane-major (utils/layout.py: [Nb,128] scalars,
[3,Nb,128] vectors). Rays are ordered into 16×32-pixel screen tiles
before tracing and scattered back at the end, so neighbouring rays of
one wavefront are spatially coherent.

The trace backend is the LBVH (accel/lbvh.py, Karras build on device)
walked by the batched XLA traversal of rt/traverse.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vkrt_jax import config as C
from vkrt_jax.accel.lbvh import BVH2, build_lbvh
from vkrt_jax.rt.traverse import trace_closest, trace_occluded
from vkrt_jax.shade import shading
from vkrt_jax.shade.sampling import (sample_material,
                                     sample_material_compact)
from vkrt_jax.utils import layout as L
from vkrt_jax.wavefront import resort

FAR_SENTINEL = 1.0e7
TILE_Y, TILE_X = 16, 32           # 512 pixels = one screen tile


class TextureArrays(NamedTuple):
    """Packed per-material-slot triple heap (scene/textures.py
    build_material_heap): one 48-byte row per texel holds the bilinear
    quads of base/metallic-roughness/normal — one gather per hit fetches
    all three maps' footprints."""
    texels_tri: jax.Array    # u8[N,48]
    level_offset: jax.Array  # i32[M,L]
    level_width: jax.Array   # i32[M,L]
    level_height: jax.Array  # i32[M,L]


def texture_arrays(images, flat) -> TextureArrays:
    """Build device TextureArrays from model images + a FlatScene (the
    material-slot mapping is derived from the FlatScene so it agrees
    with triangle_attrs by construction)."""
    from vkrt_jax.scene.textures import build_material_heap, material_slots

    triples, _ = material_slots(flat)
    heap = build_material_heap(images, triples)
    return TextureArrays(
        texels_tri=jnp.asarray(heap.texels_tri),
        level_offset=jnp.asarray(heap.level_offset),
        level_width=jnp.asarray(heap.level_width),
        level_height=jnp.asarray(heap.level_height))


def generate_rays(proj_inverse, view_inverse, width: int, height: int,
                  off=(0.5, 0.5)):
    """Camera rays (ref: shaders/shader.rgen:30-38) as [H,W] component
    grids: ((ox,oy,oz), (dx,dy,dz))."""
    xs = (jnp.arange(width, dtype=jnp.float32) + off[0]) / width * 2.0 - 1.0
    ys = (jnp.arange(height, dtype=jnp.float32) + off[1]) / height * 2.0 - 1.0
    gx, gy = jnp.meshgrid(xs, ys)
    tgt = [proj_inverse[k, 0] * gx + proj_inverse[k, 1] * gy
           + proj_inverse[k, 2] + proj_inverse[k, 3] for k in range(3)]
    n = jnp.sqrt(jnp.maximum(tgt[0] ** 2 + tgt[1] ** 2 + tgt[2] ** 2, 1e-24))
    dv = [t / n for t in tgt]
    d = [view_inverse[k, 0] * dv[0] + view_inverse[k, 1] * dv[1]
         + view_inverse[k, 2] * dv[2] for k in range(3)]
    o = [jnp.broadcast_to(view_inverse[k, 3], d[0].shape) for k in range(3)]
    return o, d


def tile(img, ty: int = TILE_Y, tx: int = TILE_X):
    """[H,W] scalar grid → [Nb,128] lane-major, tile-major ray order.

    Each 128-lane group is a compact 8x16 pixel subtile (2x2 of them per
    16x32 tile), so a group's rays stay spatially tight."""
    h, w = img.shape
    x = img.reshape(h // ty, 2, ty // 2, w // tx, 2, tx // 2)
    flat = x.transpose(0, 3, 1, 4, 2, 5).reshape(-1)
    return flat.reshape(-1, L.LANES)


def untile(lanes, height: int, width: int, ty: int = TILE_Y, tx: int = TILE_X):
    """[Nb,128] → [H,W] (inverse of tile)."""
    flat = lanes.reshape(-1)
    x = flat.reshape(height // ty, width // tx, 2, 2, ty // 2, tx // 2)
    return x.transpose(0, 2, 4, 1, 3, 5).reshape(height, width)


def _pad_dims(width, height):
    return -(-width // TILE_X) * TILE_X, -(-height // TILE_Y) * TILE_Y


def _pad_grid(g, wp, hp, value):
    h, w = g.shape
    return jnp.pad(g, ((0, hp - h), (0, wp - w)), constant_values=value)


# ---------------------------------------------------------------------------
# Trace backend (lane-major I/O: o/d [3,Nb,128], tmax [Nb,128])
# ---------------------------------------------------------------------------

# attr_table column layout (shading.interpolate reads the same rows)
ATTR_COLS = 36


class TraceBackend(NamedTuple):
    """LBVH traversal + post-trace attribute gather."""
    bvh: BVH2
    attr_table: jax.Array  # f32[T,36] per-triangle corner attrs (original order)
    scene_aabb: jax.Array  # f32[2,3] vertex AABB (resort cell keys)

    def closest(self, o, d, tmax):
        of, df = L.from_cvec(o), L.from_cvec(d)
        t, tri, u, v = trace_closest(self.bvh, of, df, C.RAY_TMIN,
                                     L.from_lanes(tmax))
        attrs = self.attr_table[jnp.maximum(tri, 0)]        # [N,36]
        attrs = jnp.moveaxis(attrs.reshape(-1, L.LANES, ATTR_COLS), -1, 0)
        return (L.to_lanes(t), L.to_lanes(u), L.to_lanes(v), attrs,
                L.to_lanes(tri >= 0))

    def occluded(self, o, d, tmax):
        occ = trace_occluded(self.bvh, L.from_cvec(o), L.from_cvec(d),
                             C.RAY_TMIN, L.from_lanes(tmax))
        return L.to_lanes(occ)


def triangle_attrs(flat) -> np.ndarray:
    """Per-triangle attribute table f32[T,36] from a FlatScene (host):
    0-2 v0, 3-5 e1, 6-8 e2, 9-17 corner normals, 18-23 corner uvs,
    24-32 corner tangents (xyz), 33 material slot
    (scene/textures.material_slots), 34-35 raw metallic-roughness /
    normal image ids (carried for debugging; shading samples by slot)."""
    from vkrt_jax.scene.textures import material_slots

    idx = np.asarray(flat.indices, dtype=np.int64)
    p = np.asarray(flat.positions, np.float32)
    v0 = p[idx[:, 0]]
    cols = [v0, p[idx[:, 1]] - v0, p[idx[:, 2]] - v0]
    cols += [flat.normals[idx[:, i]] for i in range(3)]
    cols += [flat.uvs[idx[:, i]] for i in range(3)]
    cols += [flat.tangents[idx[:, i], :3] for i in range(3)]
    _, tri_slot = material_slots(flat)
    cols.append(np.stack([tri_slot, flat.tri_metallic_roughness,
                          flat.tri_normal], axis=1))
    return np.concatenate(cols, axis=1).astype(np.float32)


@jax.jit
def build_backend(attr_table, scene_aabb) -> TraceBackend:
    """LBVH over the triangles of an attribute table (on device)."""
    bvh = build_lbvh(attr_table[:, 0:3], attr_table[:, 3:6],
                     attr_table[:, 6:9])
    return TraceBackend(bvh=bvh, attr_table=attr_table,
                        scene_aabb=scene_aabb)


@jax.jit
def rebuild_backend(attr_table, scene_aabb, m) -> TraceBackend:
    """Per-frame accel update (config 5): apply the 4x4 affine `m` (the
    TLAS-instance transform analogue, ref: src/Raytracer.cpp:1165-1177)
    to the geometry and the normal/tangent attributes, then rebuild the
    LBVH on device. Normals and tangents take the linear part and are
    renormalized by the shader, exact for rotation + uniform scale."""
    a = m[:3, :3]
    b = m[:3, 3]
    # explicit f32 products: a 3-wide `@` could run in TF32 on the GPU
    rot = lambda x: L.mat_rows3(x, a)
    cols = [rot(attr_table[:, 0:3]) + b]
    cols += [rot(attr_table[:, k:k + 3]) for k in (3, 6, 9, 12, 15)]
    cols.append(attr_table[:, 18:24])
    cols += [rot(attr_table[:, k:k + 3]) for k in (24, 27, 30)]
    cols.append(attr_table[:, 33:36])
    table = jnp.concatenate(cols, axis=1)
    lo, hi = scene_aabb[0], scene_aabb[1]
    corners = jnp.stack([jnp.stack([x, y, z]) for x in (lo[0], hi[0])
                         for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    corners = rot(corners) + b
    aabb = jnp.stack([corners.min(axis=0), corners.max(axis=0)])
    return build_backend(table, aabb)


def make_backend(flat) -> TraceBackend:
    """Build the trace backend from a FlatScene."""
    pos = np.asarray(flat.positions, dtype=np.float32)
    scene_aabb = np.stack([pos.min(axis=0), pos.max(axis=0)])
    return build_backend(jnp.asarray(triangle_attrs(flat)),
                         jnp.asarray(scene_aabb))


# ---------------------------------------------------------------------------
# The frame function (jitted once per config)
# ---------------------------------------------------------------------------

def render_frame(backend, tex: TextureArrays, proj_inverse, view_inverse,
                 lights, cfg: C.RenderConfig):
    """Render one frame. Returns (framebuffer f32[H,W,3], rays i32[Nb,128]
    traced per pixel — summed on host for the Mrays metric)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    origin_pt, dirs, valid = camera_ray_blocks(proj_inverse, view_inverse, cfg)
    accum, ray_count = wavefront_rounds(backend, tex, origin_pt, dirs, lights,
                                        cfg, valid=valid)
    fb = jnp.stack([untile(accum[k], hp, wp)[: cfg.height, : cfg.width]
                    for k in range(3)], axis=-1)
    return fb, ray_count


def render_frame_u8(backend, tex: TextureArrays, proj_inverse, view_inverse,
                    lights, cfg: C.RenderConfig):
    """render_frame + on-device UNORM8 quantization and ray-count sum, so
    the host fetches a u8 image and one scalar. Quantization matches the
    reference's UNORM storage→swapchain copy (ref:
    src/Raytracer.cpp:159-193)."""
    fb, ray_count = render_frame(backend, tex, proj_inverse, view_inverse,
                                 lights, cfg)
    fb8 = jnp.clip(fb * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
    return fb8, jnp.sum(ray_count)


def camera_ray_blocks(proj_inverse, view_inverse, cfg: C.RenderConfig):
    """Camera rays padded to tile multiples, lane-major coherent blocks.

    Returns (origin_pt f32[3] — the camera position, shared by every
    primary ray; dirs f32[3,Nb,128]; valid bool[Nb,128] — False on
    tile-padding rays, which must neither trace nor count toward the
    Mrays metric)."""
    wp, hp = _pad_dims(cfg.width, cfg.height)
    _, d = generate_rays(proj_inverse, view_inverse, cfg.width, cfg.height)
    origin_pt = view_inverse[:3, 3]
    d = jnp.stack([tile(_pad_grid(c, wp, hp, 1.0)) for c in d])
    ones = jnp.ones((cfg.height, cfg.width), jnp.bool_)
    valid = tile(_pad_grid(ones, wp, hp, False))
    return origin_pt, L.normalize3(d), valid


def wavefront_rounds(backend, tex: TextureArrays, origin_pt, dirs, lights,
                     cfg: C.RenderConfig, valid=None):
    """The trace→shade rounds over a lane-major wavefront ([3,Nb,128]).
    Pure map over rays (scene replicated) — the unit that shards across
    devices. `origin_pt` is the camera position f32[3]; `valid` masks
    tile-padding rays, which must neither trace nor count toward the
    Mrays/s metric. Returns (accum [3,Nb,128], ray_count [Nb,128])."""
    nb = dirs.shape[1]
    shape = (nb, L.LANES)
    accum = jnp.zeros((3,) + shape, jnp.float32)
    attenuation = jnp.ones(shape, jnp.float32)
    active = (jnp.ones(shape, jnp.bool_) if valid is None else valid)
    ray_count = jnp.zeros(shape, jnp.int32)
    lights = lights[:cfg.num_lights]
    origins = jnp.broadcast_to(origin_pt[:, None, None], (3,) + shape)

    for _depth in range(cfg.max_depth):
        # named scopes surface as ranges in jax.profiler traces — the
        # DebugMarker beginLabel/endLabel analogue (ref: DebugMarker.cpp)
        with jax.named_scope(f"trace_closest_d{_depth}"):
            # dead rays park with tmax=0: they cannot hit
            tmax = jnp.where(active, C.RAY_TMAX, 0.0)
            # depth>=1 resort (cfg.resort_secondary): a stable octant
            # partition packs live reflection rays together; outputs
            # are inverse-permuted, equal to the unsorted dispatch up to
            # ~1-ulp near-tie commits (wavefront/resort.py docstring)
            rs_closest = cfg.resort_secondary and _depth >= 1
            if rs_closest:
                perm = resort.radix_partition_perm(
                    resort.octant_key(dirs, active), resort.OCTANT_BITS)
                inv = resort.inverse_permutation(perm)
                o_t = resort.permute_rays(origins, perm)
                d_t = resort.permute_rays(dirs, perm)
                tm_t = resort.permute_rays(tmax, perm)
            else:
                o_t, d_t, tm_t = origins, dirs, tmax
            t, u, v, attrs, hitm = backend.closest(o_t, d_t, tm_t)
            if rs_closest:
                t = resort.permute_rays(t, inv)
                u = resort.permute_rays(u, inv)
                v = resort.permute_rays(v, inv)
                hitm = resort.permute_rays(hitm, inv)
                attrs = resort.permute_rays(attrs, inv)
        dcount = active.astype(jnp.int32)
        hit = hitm & active
        miss = active & ~hitm

        # miss shader: sky, unattenuated (ref: shader.rmiss:17 — the miss
        # shader overwrites hitValue; rgen adds it as-is)
        sky = jnp.asarray(C.SKY_COLOR)
        dacc = jnp.where(miss[None], sky[:, None, None], 0.0)

        pos, normal, uv, tangent, mat_ids = shading.interpolate(attrs, u, v)
        with jax.named_scope(f"sample_d{_depth}"):
            # one gather fetches base + metallic-roughness + normal-map quads
            # (packed material heap). Depth>=1 wavefronts are sparse, so the
            # compacted sampler gathers only live rows there.
            if _depth == 0:
                if cfg.mip_lod:
                    # beyond-parity trilinear mip filtering (config.mip_lod;
                    # lane-neighbor differentials ≡ fragment derivatives)
                    from vkrt_jax.shade.sampling import (ray_diff_lod,
                                                         sample_material_trilinear)
                    lod = ray_diff_lod(uv, hit, mat_ids[0], tex.level_width,
                                       tex.level_height, mat_ids[0])
                    base4, mr4, nmap4 = sample_material_trilinear(
                        tex.texels_tri, tex.level_offset, tex.level_width,
                        tex.level_height, mat_ids[0], uv, lod)
                else:
                    base4, mr4, nmap4 = sample_material(
                        tex.texels_tri, tex.level_offset, tex.level_width,
                        tex.level_height, mat_ids[0], uv)
            else:
                cap = min(nb, max(8, -(-nb // 4) // 8 * 8))
                base4, mr4, nmap4 = sample_material_compact(
                    tex.texels_tri, tex.level_offset, tex.level_width,
                    tex.level_height, mat_ids[0], uv, hit, cap)
        base = base4[:3]

        if cfg.flat_albedo:
            # depth-0 only in practice (config 1)
            accum = accum + dacc + jnp.where(hit[None], base, 0.0)
            ray_count = ray_count + dcount
            break

        map_n = nmap4[:3]
        metallic = mr4[2]
        pn = shading.perturbed_normal(normal, tangent, map_n)

        total_light = jnp.zeros(shape, jnp.float32)
        nl = cfg.num_lights
        geo = [shading.light_geometry(pos, lights[li]) for li in range(nl)]
        ndotls = [L.dot3(pn, g[0]) for g in geo]
        occs = [None] * nl
        if cfg.enable_shadows and nl > 0:
            # Rays a hit doesn't cast (N·L<=0 or miss) park with tmax=0.
            # Ref contract: shader.rchit:119-152.
            casts = [hit & (nd > 0) for nd in ndotls]
            # shadow rays are traced FROM THE LIGHT toward the surface
            # (same segment, same occlusion answer, epsilon mirrored to
            # the surface end): a light's rays share one origin point.
            sd = jnp.stack([-g[0] for g in geo])           # [L,3,Nb,128]
            st = jnp.stack(                                # [L,Nb,128]
                [jnp.where(c, g[1] - C.RAY_TMIN, 0.0)
                 for c, g in zip(casts, geo)])
            with jax.named_scope(f"trace_shadow_d{_depth}"):
                # shadow resort (cfg.resort_secondary, every depth): one
                # Morton-cell partition of the shared surface points
                # re-orders all lights' segments with one permutation.
                rs_shadow = cfg.resort_secondary
                if rs_shadow:
                    sperm = resort.radix_partition_perm(
                        resort.cell_key(pos, hit, backend.scene_aabb),
                        resort.CELL_KEY_BITS)
                    sinv = resort.inverse_permutation(sperm)
                    sd = resort.permute_rays(sd, sperm)
                    st = resort.permute_rays(st, sperm)
                # group (128-lane) shadow resort at depth>=1
                # (cfg.group_sort_shadows): groups sort by the Morton
                # cell of their mean live surface point, shared by all
                # lights' segments. Masks are exactly
                # permutation-independent (any-hit).
                gs_shadow = (cfg.group_sort_shadows and _depth >= 1
                             and not rs_shadow)
                if gs_shadow:
                    with jax.named_scope("group_sort"):
                        slive = st[0] > 0
                        for s in range(1, nl):
                            slive = slive | (st[s] > 0)
                        gperm = resort.radix_partition_perm(
                            resort.group_cell_key(pos, slive,
                                                  backend.scene_aabb),
                            resort.GROUP_CELL_KEY_BITS)
                        ginv_s = resort.inverse_permutation(gperm)
                        sd = resort.permute_groups(sd, gperm)
                        st = resort.permute_groups(st, gperm)
                occ_all = []
                for s in range(nl):
                    o = jnp.broadcast_to(lights[s][:, None, None],
                                         sd[s].shape)
                    occ_all.append(backend.occluded(o, sd[s], st[s]))
                occ_all = jnp.stack(occ_all)
                if gs_shadow:
                    with jax.named_scope("group_sort"):
                        occ_all = resort.permute_groups(occ_all, ginv_s)
                if rs_shadow:
                    occ_all = resort.permute_rays(occ_all, sinv)
            occs = list(occ_all)
            for c in casts:
                dcount = dcount + c.astype(jnp.int32)

        if cfg.enable_reflections:
            reflective = hit & (metallic > C.METALLIC_THRESHOLD)
            # attenuation updates BEFORE the (1 - attenuation) scale —
            # order quirk preserved (ref: shader.rchit:165-167)
            new_att = attenuation * (C.REFLECT_SCALE * metallic)
            att_updated = jnp.where(reflective, new_att, attenuation)
        else:
            reflective = jnp.zeros_like(hit)
            att_updated = attenuation

        for li in range(nl):
            diffuse = jnp.clip(ndotls[li], 0.0, 1.0)
            mult = jnp.ones(shape, jnp.float32)
            if cfg.enable_shadows:
                cast = hit & (ndotls[li] > 0)
                mult = jnp.where(cast & occs[li], C.SHADOW_MULTIPLIER,
                                 1.0)
            total_light = total_light + diffuse * geo[li][2] * mult

        hit_value = (base * (total_light * attenuation)[None]
                     + base * C.AMBIENT)
        if cfg.enable_reflections:
            hit_value = jnp.where(reflective[None],
                                  hit_value * (1.0 - att_updated)[None],
                                  hit_value)
        dacc = dacc + jnp.where(hit[None], hit_value, 0.0)

        attenuation = att_updated
        origins = L.where3(reflective, pos, origins)
        dirs = L.where3(reflective, shading.reflect(dirs, pn), dirs)
        active = reflective
        accum = accum + dacc
        ray_count = ray_count + dcount

    return accum, ray_count


# In-process cache: scene arrays, the device texture heap and the trace
# backend are shared across Renderer/Rasterizer instances, so a second
# renderer over the same scene builds and uploads nothing.
_SCENE_CACHE: dict = {}
_MODEL_CACHE: dict = {}


def load_scene_assets(scene: str, max_texture_dim: int = 0):
    """(FlatScene, TextureArrays, TraceBackend) — cached per (scene,
    texture dim). `scene` is a glTF path or a generated-scene spec
    (scene/__init__.load_scene)."""
    key = (scene, max_texture_dim)
    if key not in _SCENE_CACHE:
        from vkrt_jax.scene import flatten_model, load_scene
        model = load_scene(scene, max_texture_dim=max_texture_dim)
        flat = flatten_model(model)
        tex = texture_arrays(model.images, flat)
        _SCENE_CACHE[key] = (flat, tex, make_backend(flat))
        _MODEL_CACHE[key] = model
    return _SCENE_CACHE[key]


def cached_model(scene: str, max_texture_dim: int = 0):
    """The loaded Model behind load_scene_assets (same cache key) — for
    consumers that need raw images (e.g. the golden gate builds the
    independent oracle's per-image TextureHeap)."""
    load_scene_assets(scene, max_texture_dim)
    return _MODEL_CACHE[(scene, max_texture_dim)]


class Renderer:
    """High-level renderer: scene in, frames out (the Raytracer analogue —
    ctor does all setup, render() produces a frame; ref: src/Raytracer.hpp:11-17).
    """

    def __init__(self, scene: str, cfg: C.RenderConfig,
                 max_texture_dim: int = 0, quantize: bool = False):
        self.cfg = cfg
        self.quantize = quantize    # u8 fb + scalar rays on device
        self.flat, self.tex, self.backend = load_scene_assets(
            scene, max_texture_dim)
        self.lights = jnp.asarray(C.LIGHT_POSITIONS)
        self._frame = jax.jit(functools.partial(
            render_frame_u8 if quantize else render_frame, cfg=cfg))

    def frame_backend(self, transform=None) -> TraceBackend:
        """The backend a frame traces: the static one, or — when
        `transform` (4x4, TLAS-instance analogue) is given or
        cfg.rebuild_per_frame is set — an LBVH rebuilt on device over the
        transformed scene (BASELINE config 5; ref driver rebuild at
        src/Raytracer.cpp:1146-1280)."""
        if not (self.cfg.rebuild_per_frame or transform is not None):
            return self.backend
        m = jnp.eye(4, dtype=jnp.float32) if transform is None \
            else jnp.asarray(transform, jnp.float32)
        return rebuild_backend(self.backend.attr_table,
                               self.backend.scene_aabb, m)

    def render_async(self, camera, transform=None):
        """Enqueue a frame; returns DEVICE arrays (fb, ray_count) without
        forcing completion — JAX async dispatch makes this the
        frames-in-flight submit (pair with runtime.FrameScheduler; the
        reference overlaps CPU record with GPU execute the same way via
        3 swapchain images + fences, ref: src/Context.cpp:141-180)."""
        return self._frame(self.frame_backend(transform), self.tex,
                           jnp.asarray(camera.proj_inverse),
                           jnp.asarray(camera.view_inverse),
                           self.lights)

    def render(self, camera, transform=None):
        """Synchronous render: enqueue + materialize on host."""
        fb, rays = self.render_async(camera, transform)
        return np.asarray(fb), int(np.asarray(rays).sum())
