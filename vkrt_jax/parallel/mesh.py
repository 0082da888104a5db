"""Multi-device scaling — rays sharded over a device mesh, scene replicated.

The reference is strictly single-GPU (SURVEY.md §2: one VkDevice, one
queue, no collectives). Here the ray wavefront is embarrassingly
parallel, so frames shard over a 1-D `rays` mesh axis with `shard_map`;
the scene (LBVH + attribute table + texture heap) is replicated per
device, and the only cross-device traffic is the framebuffer gather
(NCCL over NVLink on a multi-GPU host). The cards of one host reach each
other all to all, so the mesh follows the algorithm: one axis.

XLA inserts the collective for the sharded→replicated output transition.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from vkrt_jax import config as C
from vkrt_jax.raster import pipeline as raster
from vkrt_jax.wavefront import engine

BLOCK_GROUPS = 4                  # 128-lane groups per 512-ray screen tile


def make_mesh(devices=None, axis: str = "rays") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma off: the per-device body initializes loop carries from
    # replicated zeros, which trips the varying-axes checker even though
    # no cross-device communication exists inside the body.
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _pad_blocks(x, n_dev: int, axis: int, value):
    """Pad the block axis so each device gets whole 512-ray tiles."""
    nb = x.shape[axis]
    per_dev = -(-nb // (n_dev * BLOCK_GROUPS)) * BLOCK_GROUPS
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, per_dev * n_dev - nb)
    return jnp.pad(x, pad, constant_values=value)


def render_frame_sharded(backend, tex, proj_inverse, view_inverse, lights,
                         cfg: C.RenderConfig, mesh: Mesh):
    """Distributed render_frame: identical output, rays split across
    devices. Lane-major wavefront [3, Nb, 128] shards along Nb."""
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    wp, hp = engine._pad_dims(cfg.width, cfg.height)

    origin_pt, dirs, valid = engine.camera_ray_blocks(proj_inverse,
                                                      view_inverse, cfg)
    nb = dirs.shape[1]
    # padding rays are invalid (never traced as live, never counted);
    # live directions must stay bit-equal to render_frame's
    dirs = _pad_blocks(dirs, n_dev, 1, 1.0)
    valid = _pad_blocks(valid, n_dev, 0, False)

    rounds = functools.partial(engine.wavefront_rounds, cfg=cfg)
    fn = _shard_map(
        lambda be, tx, op, d, li, va: rounds(be, tx, op, d, li, valid=va),
        mesh,
        in_specs=(P(), P(), P(), P(None, axis, None), P(), P(axis, None)),
        out_specs=(P(None, axis, None), P(axis, None)),
    )
    accum, ray_count = fn(backend, tex, origin_pt, dirs, lights, valid)
    accum = accum[:, :nb]
    fb = jnp.stack([engine.untile(accum[k], hp, wp)[: cfg.height, : cfg.width]
                    for k in range(3)], axis=-1)
    return fb, ray_count[:nb]


def render_raster_frame_sharded(backend, tex, proj_inverse, view_inverse,
                                cfg: C.RenderConfig, mesh: Mesh,
                                msaa: int = 1):
    """Distributed ray-cast raster frame: identical output, each MSAA
    sample's pixel blocks split across devices, scene replicated."""
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    fn = _shard_map(raster.raster_color_lanes, mesh,
                    in_specs=(P(), P(), P(None, axis, None),
                              P(None, axis, None)),
                    out_specs=P(None, axis, None))
    offsets = raster.msaa_offsets(msaa)
    acc = None
    for off in offsets:
        o, d = raster.sample_rays(proj_inverse, view_inverse, cfg, off)
        nb = o.shape[1]
        o = _pad_blocks(o, n_dev, 1, engine.FAR_SENTINEL)
        d = _pad_blocks(d, n_dev, 1, 1.0)
        s = raster.untile_rgb(fn(backend, tex, o, d)[:, :nb], cfg)
        acc = s if acc is None else acc + s
    return acc / len(offsets)
