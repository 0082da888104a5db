"""CLI entry point — the main.cpp analogue, promoted to a real interface.

The reference has zero CLI (main(void), compile-time constants everywhere —
SURVEY.md §5); here every baked constant is a flag. Examples:

  python -m vkrt_jax.app.cli --config 1 --output /tmp/frame.png
  python -m vkrt_jax.app.cli --config 4 --frames 240 --metrics
  python -m vkrt_jax.app.cli --width 1600 --height 1200 --shard 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from vkrt_jax.config import DEFAULT_SCENE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkrt-jax",
        description="JAX wavefront ray tracer (vkrt capability port)")
    p.add_argument("--scene", default=DEFAULT_SCENE,
                   help="'generated[:SEED]' (the seeded reference scene) "
                        "or a glTF path")
    p.add_argument("--config", type=int, choices=[1, 2, 3, 4, 5],
                   help="BASELINE.json benchmark config")
    p.add_argument("--width", type=int, help="override resolution width")
    p.add_argument("--height", type=int, help="override resolution height")
    p.add_argument("--max-depth", type=int, help="override bounce depth")
    p.add_argument("--lights", type=int, help="override light count (0-4)")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-reflections", action="store_true")
    p.add_argument("--frames", type=int, default=1,
                   help=">1 renders the scripted fly-through path")
    p.add_argument("--output", help="PNG (or .npy) output path")
    p.add_argument("--max-texture-dim", type=int, default=0,
                   help="downsample textures at load (0 = full res)")
    p.add_argument("--metrics", action="store_true", help="print metrics JSON")
    p.add_argument("--profile-dir", help="write a jax.profiler trace here")
    p.add_argument("--check-finite", action="store_true",
                   help="NaN/Inf sentinel on every frame")
    p.add_argument("--checkpoint",
                   help="checkpoint path: saved every frame; resumes if present")
    p.add_argument("--raster", action="store_true",
                   help="use the classic raster pipeline instead of RT")
    p.add_argument("--shard", type=int, nargs="?", const=-1, default=None,
                   metavar="N",
                   help="shard rays across a device mesh: bare --shard = "
                        "all visible devices; --shard N = the first N "
                        "(an error when fewer are visible)")
    p.add_argument("--msaa", type=int, default=8, choices=[1, 8],
                   help="raster-path MSAA sample count")
    p.add_argument("--mip-lod", action="store_true",
                   help="beyond-parity: trilinear mip filtering from "
                        "wavefront ray differentials (the reference's RT "
                        "stage always samples mip 0, so golden configs "
                        "keep this off)")
    p.add_argument("--resort", action="store_true",
                   help="re-order reflection + shadow wavefronts into "
                        "coherent ray order (wavefront/resort.py; off by "
                        "default)")
    return p


def resolve_config(args):
    from vkrt_jax import config as C
    cfg = C.BASELINE_CONFIGS[args.config]() if args.config else C.reference_config()
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.max_depth:
        overrides["max_depth"] = args.max_depth
    if args.lights is not None:
        overrides["num_lights"] = args.lights
    if args.no_shadows:
        overrides["enable_shadows"] = False
    if args.no_reflections:
        overrides["enable_reflections"] = False
    if args.mip_lod:
        overrides["mip_lod"] = True
    if args.resort:
        overrides["resort_secondary"] = True
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _shard_devices(n: int):
    """Resolve --shard N to a device list (N <= 0: every visible device)."""
    import jax

    devices = jax.devices()
    if n > len(devices):
        raise SystemExit(f"--shard {n}: only {len(devices)} device(s) "
                         f"visible: {devices}")
    return devices if n <= 0 else devices[:n]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)

    from vkrt_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from vkrt_jax import config as C
    from vkrt_jax.app import framebuffer
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.app.flythrough import camera_path
    from vkrt_jax.app.metrics import FrameTimer, check_finite, profile
    from vkrt_jax.app.state import load_state, save_state

    if args.shard:
        import jax.numpy as jnp

        from vkrt_jax.parallel.mesh import (make_mesh, render_frame_sharded,
                                            render_raster_frame_sharded)
        from vkrt_jax.wavefront.engine import load_scene_assets

        mesh = make_mesh(_shard_devices(args.shard))
        print(f"sharding {'raster pixels' if args.raster else 'rays'} over "
              f"{mesh.devices.size} devices", file=sys.stderr)
        _, tex, be = load_scene_assets(args.scene, args.max_texture_dim)
        lights = jnp.asarray(C.LIGHT_POSITIONS)

        class _Sharded:
            def render(self, camera):
                if args.raster:
                    return np.asarray(render_raster_frame_sharded(
                        be, tex, jnp.asarray(camera.proj_inverse),
                        jnp.asarray(camera.view_inverse), cfg, mesh,
                        msaa=args.msaa))
                fb, rays = render_frame_sharded(
                    be, tex, jnp.asarray(camera.proj_inverse),
                    jnp.asarray(camera.view_inverse), lights, cfg, mesh)
                return np.asarray(fb), int(np.asarray(rays).sum())

        renderer = _Sharded()
    elif args.raster:
        from vkrt_jax.raster import Rasterizer
        renderer = Rasterizer(args.scene, cfg,
                              max_texture_dim=args.max_texture_dim,
                              msaa=args.msaa)
    else:
        from vkrt_jax.wavefront.engine import Renderer
        # quantize on device (u8 fb + scalar ray count) unless the caller
        # needs the f32 image on the host
        quantize = not args.check_finite and not (
            args.output and args.output.endswith(".npy"))
        renderer = Renderer(args.scene, cfg,
                            max_texture_dim=args.max_texture_dim,
                            quantize=quantize)

    start_frame = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        _, _, start_frame, _ = load_state(args.checkpoint)
        print(f"resuming at frame {start_frame}", file=sys.stderr)

    if args.frames > 1:
        cams = camera_path(cfg.width, cfg.height)
    else:
        cam = Camera(cfg.width, cfg.height)
        cam.set_position(C.CAMERA_START_POSITION)
        cam.set_rotation(C.CAMERA_START_ROTATION)
        cams = iter([cam])

    timer = FrameTimer()
    fb = None
    # frames-in-flight: JAX async dispatch + FrameScheduler overlap host
    # frame prep (camera path, checkpointing) and device execution of up
    # to `inflight` frames — the reference's 3-swapchain-image pipelining
    # (ref: src/Context.cpp:141-180). Raster/sharded paths stay serial.
    pipeline = (args.frames > 1 and not args.raster
                and hasattr(renderer, "render_async"))

    def retire(idx, cam, out):
        nonlocal fb
        fb, rays_arr = out
        rays = int(np.asarray(rays_arr).sum())
        stats = timer.end(rays)
        timer.begin()
        if args.check_finite:
            check_finite(fb, f"frame {idx}")
        if args.checkpoint:
            save_state(args.checkpoint, cfg, cam, idx + 1)
        if args.metrics:
            print(f"frame {idx}: {stats.frame_ms:.1f}ms "
                  f"{stats.mrays_per_s:.2f} Mrays/s", file=sys.stderr)

    with profile(args.profile_dir):
        if pipeline:
            from vkrt_jax.runtime import FrameScheduler
            sched = FrameScheduler(inflight=3)
            in_flight_cams = {}
            timer.begin()
            for i in range(args.frames):
                try:
                    cam = next(cams)
                except StopIteration:
                    break
                if i < start_frame:
                    continue  # fast-forward a resumed fly-through
                in_flight_cams[i] = cam
                retired = sched.submit(renderer.render_async, cam)
                if retired is not None:
                    idx, out = retired
                    idx += start_frame
                    retire(idx, in_flight_cams.pop(idx), out)
            for idx, out in sched.drain():
                idx += start_frame
                retire(idx, in_flight_cams.pop(idx), out)
        else:
            for i in range(args.frames):
                try:
                    cam = next(cams)
                except StopIteration:
                    break
                if i < start_frame:
                    continue  # fast-forward a resumed fly-through
                timer.begin()
                if args.raster:
                    fb = renderer.render(cam)
                    rays = cfg.num_pixels * args.msaa
                else:
                    fb, rays = renderer.render(cam)
                stats = timer.end(rays)
                if args.check_finite:
                    check_finite(fb, f"frame {i}")
                if args.checkpoint:
                    save_state(args.checkpoint, cfg, cam, i + 1)
                if args.metrics:
                    print(f"frame {i}: {stats.frame_ms:.1f}ms "
                          f"{stats.mrays_per_s:.2f} Mrays/s", file=sys.stderr)

    if args.output and fb is not None:
        if args.output.endswith(".npy"):
            framebuffer.write_npy(args.output, fb)
        else:
            framebuffer.write_png(args.output, fb)
        print(f"wrote {args.output}", file=sys.stderr)

    if args.metrics:
        print(json.dumps(timer.summary()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
