"""Raster pipeline — the reference's classic forward path, ray-cast.

The reference's alternative renderer (ref: src/Rasterizer.{hpp,cpp})
draws the same scene with: one WVP matrix (P·V·scale(0.01), per-frame
UBO, ref: Rasterizer.cpp:172-195), 8xMSAA color + depth + resolve
(ref: Rasterizer.cpp:17,266-338), per-submesh textured draws, an unlit
fragment shader with `discard` below alpha 0.1 (ref: shaders/shader.frag:
13-22), clear color (0, 0, 0.2) (ref: Rasterizer.cpp:119), and an ImGui
FPS overlay (ref: Rasterizer.cpp:151-161).

Design: visibility is a primary-ray wavefront through the same trace
backend as the RT path, with the raster-specific contract on top:

  * 8xMSAA: the standard Vulkan/D3D 8-sample pixel pattern, one
    visibility pass per sample, averaged resolve
  * alpha `discard`: hits with baseColor.a < 0.1 continue behind the
    surface (bounded continuation rounds), exactly the fragment-kill
    semantics
  * unlit textured shading + (0, 0, 0.2) background

Perspective/camera math is shared with the RT path (identical P·V), so
both paths see the same geometry — as in the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vkrt_jax import config as C
from vkrt_jax.shade import shading
from vkrt_jax.shade.sampling import sample_material
from vkrt_jax.utils import layout as L
from vkrt_jax.wavefront import engine

CLEAR_COLOR = np.array([0.0, 0.0, 0.2], dtype=np.float32)  # ref: Rasterizer.cpp:119
ALPHA_DISCARD = 0.1        # ref: shaders/shader.frag:16-20
MAX_DISCARD_ROUNDS = 4

# Standard 8x MSAA sample positions (pixel space, Vulkan/D3D pattern;
# ref MSAA config: VK_SAMPLE_COUNT_8_BIT at Rasterizer.cpp:17)
MSAA8 = np.array([
    [0.5625, 0.3125], [0.4375, 0.6875], [0.8125, 0.5625], [0.3125, 0.1875],
    [0.1875, 0.8125], [0.0625, 0.4375], [0.6875, 0.9375], [0.9375, 0.0625],
], dtype=np.float32)


def sample_rays(proj_inverse, view_inverse, cfg: C.RenderConfig, off):
    """Tiled camera rays of one MSAA sample: (origins, dirs) [3,Nb,128].
    Tile-padding rays start at FAR_SENTINEL, which marks them dead."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    o, d = engine.generate_rays(proj_inverse, view_inverse,
                                cfg.width, cfg.height, off=tuple(off))
    origins = jnp.stack([engine.tile(engine._pad_grid(c, wp, hp,
                                                      engine.FAR_SENTINEL))
                         for c in o])
    dirs = L.normalize3(jnp.stack(
        [engine.tile(engine._pad_grid(c, wp, hp, 1.0)) for c in d]))
    return origins, dirs


def raster_color_lanes(backend, tex, origins, dirs):
    """Unlit colour [3,Nb,128] of one MSAA sample pass, with alpha-discard
    continuation. A pure map over rays — the unit `parallel.mesh` shards
    across devices."""
    shape = origins.shape[1:]
    color = jnp.broadcast_to(jnp.asarray(CLEAR_COLOR)[:, None, None],
                             (3,) + shape)
    # still needs a surface; padded rays (FAR origin) never become live
    live = origins[0] != engine.FAR_SENTINEL
    for _round in range(MAX_DISCARD_ROUNDS):
        # dead rays park with tmax=0 (see wavefront.engine.wavefront_rounds)
        tmax = jnp.where(live, C.RAY_TMAX, 0.0)
        t, u, v, attrs, hitm = backend.closest(origins, dirs, tmax)
        hit = hitm & live
        pos, _, uv, _, mat_ids = shading.interpolate(attrs, u, v)
        texel, _, _ = sample_material(tex.texels_tri, tex.level_offset,
                                      tex.level_width, tex.level_height,
                                      mat_ids[0], uv)
        opaque = hit & (texel[3] >= ALPHA_DISCARD)
        discarded = hit & ~opaque
        color = L.where3(opaque, texel[:3], color)
        # discarded fragments: continue behind the surface (fragment kill)
        origins = L.where3(discarded, pos + dirs * 1e-4, origins)
        live = discarded
    return color


def untile_rgb(color, cfg: C.RenderConfig):
    """[3,Nb,128] lane-major colour → [H,W,3] image."""
    wp, hp = engine._pad_dims(cfg.width, cfg.height)
    return jnp.stack([engine.untile(color[k], hp, wp)[: cfg.height,
                                                      : cfg.width]
                      for k in range(3)], axis=-1)


def msaa_offsets(msaa: int):
    return MSAA8 if msaa == 8 else np.array([[0.5, 0.5]], np.float32)


def render_raster_frame(backend, tex, proj_inverse, view_inverse,
                        cfg: C.RenderConfig, msaa: int = 8):
    """Full raster frame: msaa in {1, 8} sample passes, averaged resolve."""
    offsets = msaa_offsets(msaa)
    acc = None
    for off in offsets:
        o, d = sample_rays(proj_inverse, view_inverse, cfg, off)
        s = untile_rgb(raster_color_lanes(backend, tex, o, d), cfg)
        acc = s if acc is None else acc + s
    return acc / len(offsets)


class Rasterizer:
    """ctor + render() — same shape as the reference Rasterizer
    (ref: src/Rasterizer.hpp:12-18), with the FPS overlay of the raster
    path (ref: Rasterizer.cpp:151-161) burned in by app/overlay.py."""

    def __init__(self, scene: str, cfg: C.RenderConfig,
                 max_texture_dim: int = 0, msaa: int = 8):
        self.cfg = cfg
        self.msaa = msaa
        self.flat, self.tex, self.backend = engine.load_scene_assets(
            scene, max_texture_dim)
        self._frame = jax.jit(functools.partial(
            render_raster_frame, cfg=cfg, msaa=msaa))

    def render(self, camera, show_fps: bool = True):
        import time

        from vkrt_jax.app.overlay import draw_text

        t0 = time.perf_counter()
        fb = np.asarray(self._frame(self.backend, self.tex,
                                    jnp.asarray(camera.proj_inverse),
                                    jnp.asarray(camera.view_inverse)))
        dt = time.perf_counter() - t0
        if show_fps:
            fb = draw_text(fb, f"FPS {1.0 / max(dt, 1e-9):.1f}", 8, 8)
        return fb
