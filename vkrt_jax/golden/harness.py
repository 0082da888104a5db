"""Golden-image harness CLI — engine vs the independent CPU oracle.

The BASELINE.json acceptance metric is ≤1e-3 RMSE against the reference
frame; with no Vulkan GPU available, the brute-force oracle is the
golden source (see golden/cpu_tracer.py). This tool renders the same
frame through the real engine and through the oracle and reports RMSE —
the standalone version of tests/test_golden.py, usable on any scene,
config, pose, and resolution:

  python -m vkrt_jax.golden.harness --config 3 --width 96 --height 64
  python -m vkrt_jax.golden.harness --config 2 --submeshes 10 \
      --oracle native --save-diff diff.png

`golden_gate` is the gate bench.py and chip_smoke.py apply on the device:
the reference workload through the production path against the native
oracle, with the oracle-certified pixel set.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from vkrt_jax.app.cli import DEFAULT_SCENE, build_parser, resolve_config

# Golden gate bars (app/framebuffer.golden_metrics):
#   rmse_stable  — raw RMSE over the oracle-certified pixel set (pixels
#                  every correct f32 tracer must reproduce; the excluded
#                  boundary pixels are flagged a priori by the oracle's
#                  margin analysis, never by observed differences)
#   stable_frac  — the certified set must cover >= 90% of the image (a
#                  mask that eats the frame would be no gate)
#   rmse_trimmed / flip_frac — systematic-error tripwires over the whole
#                  frame (broad breakage shows in both; no mask hides it)
GOLDEN_BARS = {"rmse_stable": ("<=", 1e-3), "stable_frac": (">=", 0.90),
               "rmse_trimmed": ("<=", 1e-3), "flip_frac": ("<=", 1e-3)}


def golden_gate(scene: str = DEFAULT_SCENE, max_texture_dim: int = 0,
                width: int = 640, height: int = 480) -> dict:
    """The reference workload (depth 2, 4 lights) at width x height from
    the contract camera: an f32 frame through the production path on the
    default device vs the native oracle. Returns golden_metrics plus
    "failures", the bars it misses."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.app.framebuffer import golden_metrics
    from vkrt_jax.golden import render_golden
    from vkrt_jax.scene import build_texture_heap
    from vkrt_jax.wavefront.engine import (cached_model, load_scene_assets,
                                           render_frame)

    flat, tex, backend = load_scene_assets(scene, max_texture_dim)
    cfg = dataclasses.replace(C.reference_config(), width=width,
                              height=height)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    frame = jax.jit(functools.partial(render_frame, cfg=cfg))
    fb, _ = frame(backend, tex, jnp.asarray(cam.proj_inverse),
                  jnp.asarray(cam.view_inverse),
                  jnp.asarray(C.LIGHT_POSITIONS))
    model = cached_model(scene, max_texture_dim)
    golden, stable = render_golden(
        flat, build_texture_heap(model.images), cam.proj_inverse,
        cam.view_inverse, cfg, accel="native", with_stable=True)
    m = golden_metrics(np.asarray(fb), golden, stable=stable)
    m["failures"] = [f"{k} {m[k]} (bar {op} {bar})"
                     for k, (op, bar) in GOLDEN_BARS.items()
                     if not (m[k] <= bar if op == "<=" else m[k] >= bar)]
    return m


def main(argv=None) -> int:
    base = build_parser()
    p = argparse.ArgumentParser(parents=[base], add_help=False,
                                prog="vkrt-jax-golden")
    p.add_argument("--submeshes", type=int, default=0,
                   help="limit to the first N submeshes (keeps the brute "
                        "oracle tractable; 0 = all)")
    p.add_argument("--oracle", choices=["brute", "native"], default="brute")
    p.add_argument("--save-diff", help="write |engine - oracle| heatmap PNG")
    p.add_argument("--threshold", type=float, default=1e-3)
    args = p.parse_args(argv)
    cfg = resolve_config(args)

    import jax.numpy as jnp

    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.app.framebuffer import rmse, write_png
    from vkrt_jax.golden import render_golden
    from vkrt_jax.scene import flatten_model, load_scene
    from vkrt_jax.scene.model import Model
    from vkrt_jax.wavefront.engine import (make_backend, render_frame,
                                           texture_arrays)

    model = load_scene(args.scene or DEFAULT_SCENE,
                       max_texture_dim=args.max_texture_dim or 64)
    if args.submeshes:
        model = Model(submeshes=model.submeshes[: args.submeshes],
                      materials=model.materials, images=model.images)
    flat = flatten_model(model)
    tex = texture_arrays(model.images, flat)
    from vkrt_jax.scene import build_texture_heap
    heap = build_texture_heap(model.images)   # oracle-side (independent)
    backend = make_backend(flat)
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)

    fb, _ = render_frame(backend, tex, jnp.asarray(cam.proj_inverse),
                         jnp.asarray(cam.view_inverse),
                         jnp.asarray(C.LIGHT_POSITIONS), cfg)
    fb = np.asarray(fb)
    golden = render_golden(flat, heap, cam.proj_inverse, cam.view_inverse,
                           cfg, accel=args.oracle)

    err = rmse(fb, golden)
    result = {
        "rmse": err,
        "threshold": args.threshold,
        "pass": bool(err <= args.threshold),
        "resolution": [cfg.width, cfg.height],
        "oracle": args.oracle,
        "submeshes": args.submeshes or len(model.submeshes),
    }
    if args.save_diff:
        diff = np.abs(np.clip(fb, 0, 1) - np.clip(golden, 0, 1))
        write_png(args.save_diff, diff / max(diff.max(), 1e-6))
        result["diff_png"] = args.save_diff
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
