"""Benchmark: config-4 frames of the seeded reference scene on one GPU.

Metric: Mrays/s and frame ms at 1920x1080, depth 2 (primary + one
reflection bounce), 4 lights with shadows — the reference workload's
shading contract at config-4 resolution — on the seeded reference scene
at full texture resolution. Prints the card (`name, power.limit` from
nvidia-smi) and then one JSON line with:

  frame_ms / mrays_per_s   median of --reps frames run one at a time,
                           each ending in block_until_ready
  pipelined_frame_ms       wall time per frame of --reps frames in flight
                           through runtime.FrameScheduler, each ending in
                           a device→host fetch of the u8 image
  rebuild_lbvh_ms          per-frame accel update (config 5): transform +
                           on-device LBVH rebuild, mean of 3
  golden_*                 the golden gate (golden/harness.golden_gate)
  device                   platform, kind and count as JAX reports them

With --trace DIR, one more frame runs under jax.profiler and the JSON
gains "trace": device ms per named scope, the top ops, and the device's
busy and idle time over the frame (app/metrics.scope_device_times).

  python bench.py
  python bench.py --trace frame_trace

Exits non-zero when no GPU is visible or the golden gate fails.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--trace", help="also profile one frame into this dir")
    args = p.parse_args(argv)

    from vkrt_jax.runtime import card_info, device_record, require_gpu
    require_gpu()
    card = card_info()
    print(f"card: {card}", flush=True)

    import jax
    import jax.numpy as jnp

    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.golden.harness import golden_gate
    from vkrt_jax.runtime import FrameScheduler
    from vkrt_jax.utils.cache import enable_compilation_cache
    from vkrt_jax.wavefront.engine import Renderer, rebuild_backend

    enable_compilation_cache()
    cfg = C.config4_flythrough()   # 1920x1080, depth 2, 4 lights
    t0 = time.perf_counter()
    renderer = Renderer(C.DEFAULT_SCENE, cfg, quantize=True)
    setup_s = time.perf_counter() - t0
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)

    t0 = time.perf_counter()
    _, rays = renderer.render(cam)                          # compile
    first_frame_s = time.perf_counter() - t0

    # frames in flight: wall time of --reps frames through the scheduler
    sched = FrameScheduler(inflight=3)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        retired = sched.submit(renderer.render_async, cam)
        if retired is not None and int(retired[1][1]) != rays:
            raise RuntimeError(f"ray count {int(retired[1][1])} != {rays}")
    for _, out in sched.drain():
        if int(out[1]) != rays:
            raise RuntimeError(f"ray count {int(out[1])} != {rays}")
    pipelined_ms = (time.perf_counter() - t0) / args.reps * 1e3

    # one frame at a time, each ending in block_until_ready
    frame_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render_async(cam))
        frame_ms.append((time.perf_counter() - t0) * 1e3)

    be = renderer.backend
    eye = jnp.eye(4, dtype=jnp.float32)
    jax.block_until_ready(rebuild_backend(be.attr_table, be.scene_aabb, eye))
    t0 = time.perf_counter()
    for _ in range(3):
        rebuilt = rebuild_backend(be.attr_table, be.scene_aabb, eye)
    jax.block_until_ready(rebuilt)
    rebuild_ms = (time.perf_counter() - t0) / 3 * 1e3

    med = statistics.median(frame_ms)
    result = {
        "metric": "Mrays/s, config 4 (1920x1080, depth 2, 4 lights), "
                  "seeded reference scene",
        "mrays_per_s": rays / (med / 1e3) / 1e6,
        "frame_ms": med,
        "frame_ms_all": frame_ms,
        "pipelined_frame_ms": pipelined_ms,
        "rays_per_frame": rays,
        "rebuild_lbvh_ms": rebuild_ms,
        "setup_s": setup_s,
        "first_frame_s": first_frame_s,
        "card": card,
        "device": device_record(),
    }
    if args.trace:
        from vkrt_jax.app.metrics import scope_device_times
        frame_args = (be, renderer.tex, jnp.asarray(cam.proj_inverse),
                      jnp.asarray(cam.view_inverse), renderer.lights)
        compiled = renderer._frame.lower(*frame_args).compile()
        jax.block_until_ready(compiled(*frame_args))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(compiled(*frame_args))
        hlo = compiled.as_text()
        with open(os.path.join(args.trace, "frame.hlo.txt"), "w") as f:
            f.write(hlo)
        result["trace"] = scope_device_times(args.trace, hlo)
    gate = golden_gate()
    result.update({f"golden_{k}": v for k, v in gate.items()})
    print(json.dumps(result))
    if gate["failures"]:
        print(f"FAIL: golden gate: {gate['failures']}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
