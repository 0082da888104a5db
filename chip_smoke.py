"""Smoke test of the renderer on the GPU: the main path, phase by phase.

  python chip_smoke.py           # phases 1-7 on one card
  python chip_smoke.py --multi   # only the 4-card sharded frame vs 1 card

Phases (one process; any failure exits non-zero before the last line):
  1. the card (nvidia-smi name, power limit) and jax.devices()
  2. config 4 (1920x1080, depth 2, 4 lights) through Renderer +
     FrameScheduler on the seeded reference scene at full texture
     resolution: 5 frames, median frame ms and Mrays/s
  3. trace_closest / trace_occluded on the card vs the native C++ BVH
     oracle over 2^20 rays (contract-camera primaries + seeded random
     rays): on oracle-certified rays hits and triangle ids exact, t
     within rtol 1e-5
  4. build_lbvh of the full scene on the card and on the host CPU: the
     card's tree passes the LBVH invariants, phase 3's rays give the
     same answers through both trees; differing Morton keys reported
  5. the golden gate: the reference workload at 640x480 vs the native
     oracle (golden/harness.golden_gate)
  6. config 5: 3 frames with a per-frame transform (LBVH rebuilt on the
     card); the identity-transform frame equals the static frame
  7. raster: one 8xMSAA 800x600 frame through Rasterizer, finite; at
     160x120 against the raster oracle, RMSE <= 1e-3
With --multi: config 4 through render_frame_sharded on a 4-card `rays`
mesh against the same frame on one card, max|d| <= 1e-5 and equal ray
counts.

The line before the last is the card's `name, power.limit`; the last
line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vkrt_jax.runtime import card_info, device_record, require_gpu  # noqa: E402

N_RAYS = 1 << 20


def log(msg):
    print(msg, flush=True)


def contract_camera(width, height):
    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera

    cam = Camera(width, height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return cam


def phase_frames(renderer, cfg, card, n=5):
    import jax
    import numpy as np

    from vkrt_jax.runtime import FrameScheduler

    cam = contract_camera(cfg.width, cfg.height)
    t0 = time.perf_counter()
    fb, rays = renderer.render(cam)
    first_s = time.perf_counter() - t0
    assert fb.shape == (cfg.height, cfg.width, 3) and fb.dtype == np.uint8
    assert rays >= cfg.width * cfg.height, rays
    # frames in flight: wall time of n frames through the scheduler
    sched = FrameScheduler(inflight=3)
    outs = []
    t0 = time.perf_counter()
    for _ in range(n):
        retired = sched.submit(renderer.render_async, cam)
        if retired is not None:
            outs.append(retired[1])
    outs += [out for _, out in sched.drain()]
    pipelined = (time.perf_counter() - t0) / n * 1e3
    assert all(int(o[1]) == rays for o in outs)
    same = [bool(np.array_equal(o[0], fb)) for o in outs]
    # one frame at a time, each ending in block_until_ready
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render_async(cam))
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f"phase 2 ok: config 4 first frame {first_s:.1f} s (compile); "
        f"{n} frames in flight {pipelined} ms/frame; one at a time median "
        f"{med} ms (all {times}); {rays} rays/frame, {rays / med / 1e3} "
        f"Mrays/s at the median, on {card}; frames equal to the first: "
        f"{same}")


def test_rays(flat, n):
    """n/2 contract-camera primaries (1024 wide) + seeded random rays
    inside the scene, and per-ray segment lengths for the occlusion
    test."""
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.golden.cpu_tracer import generate_camera_rays

    h = n // 2 // 1024
    cam = contract_camera(1024, h)
    o1, d1 = generate_camera_rays(1024, h, cam.proj_inverse,
                                  cam.view_inverse)
    rng = np.random.default_rng(7)
    k = n - o1.shape[0]
    lo, hi = flat.aabb
    o2 = rng.uniform(lo + 0.5, hi - 0.5, (k, 3)).astype(np.float32)
    d2 = rng.normal(size=(k, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    seg = rng.uniform(0.1, 30.0, n).astype(np.float32)
    return o, d, np.full(n, C.RAY_TMAX, np.float32), seg


def trace_on_card(bvh, o, d, tmax, seg):
    import jax.numpy as jnp
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.rt.traverse import trace_closest, trace_occluded

    t, tri, _, _ = trace_closest(bvh, jnp.asarray(o), jnp.asarray(d),
                                 C.RAY_TMIN, jnp.asarray(tmax))
    occ = trace_occluded(bvh, jnp.asarray(o), jnp.asarray(d), C.RAY_TMIN,
                         jnp.asarray(seg))
    return np.asarray(t), np.asarray(tri), np.asarray(occ)


def phase_trace(flat, backend):
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.native import NativeBVH

    o, d, tmax, seg = test_rays(flat, N_RAYS)
    a = np.asarray(backend.attr_table)
    oracle = NativeBVH(a[:, 0:3], a[:, 3:6], a[:, 6:9])
    t0 = time.perf_counter()
    ot, otri, _, _, cst = oracle.closest_stable(o, d, C.RAY_TMIN, tmax)
    oocc, ost = oracle.occluded_stable(o, d, C.RAY_TMIN, seg)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t, tri, occ = trace_on_card(backend.bvh, o, d, tmax, seg)
    card_s = time.perf_counter() - t0
    hit, ohit = tri >= 0, otri >= 0
    bad_hit = int((hit != ohit)[cst].sum())
    bad_tri = int((tri != otri)[cst & ohit].sum())
    both = cst & ohit & hit
    rel = np.abs(t[both] - ot[both]) / np.maximum(np.abs(ot[both]), 1e-30)
    bad_t = int((rel > 1e-5).sum())
    bad_occ = int((occ != oocc)[ost].sum())
    log(f"phase 3: {N_RAYS} rays, certified {cst.mean():.4f} closest / "
        f"{ost.mean():.4f} occlusion, hit frac {ohit.mean():.4f}; "
        f"certified mismatches: hit {bad_hit}, tri {bad_tri}, t {bad_t} "
        f"(max rel {rel.max() if rel.size else 0.0:.2e}), occluded "
        f"{bad_occ}; all-ray mismatches: tri {int((tri != otri).sum())}, "
        f"occluded {int((occ != oocc).sum())}; card {card_s:.2f} s "
        f"(incl. compile), oracle {oracle_s:.2f} s")
    assert bad_hit == bad_tri == bad_t == bad_occ == 0
    log("phase 3 ok")
    return (o, d, tmax, seg), (t, tri, occ), (cst, ost)


def check_lbvh(bvh):
    """The LBVH invariants: every leaf reachable exactly once from the
    root, every internal node reachable once, and each stored child box
    equal to the union of that child's own boxes (leaf boxes at the
    bottom) — so every box contains its descendants."""
    import numpy as np

    kids = np.asarray(bvh.kids)
    boxes = np.asarray(bvh.boxes)
    v0, e1, e2 = (np.asarray(x) for x in (bvh.tri_v0, bvh.tri_e1,
                                          bvh.tri_e2))
    T = v0.shape[0]
    assert kids.shape == (T - 1, 2)
    leaf = kids < 0
    leaves = np.sort(-kids[leaf] - 1)
    np.testing.assert_array_equal(leaves, np.arange(T))
    internal = np.sort(kids[~leaf])
    np.testing.assert_array_equal(internal, np.arange(1, T - 1))
    lmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    lmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    for side in (0, 1):
        k = kids[:, side]
        bmin, bmax = boxes[:, 6 * side:6 * side + 3], \
            boxes[:, 6 * side + 3:6 * side + 6]
        lk = k < 0
        np.testing.assert_array_equal(bmin[lk], lmin[-k[lk] - 1])
        np.testing.assert_array_equal(bmax[lk], lmax[-k[lk] - 1])
        c = k[~lk]
        np.testing.assert_array_equal(
            bmin[~lk], np.minimum(boxes[c, 0:3], boxes[c, 6:9]))
        np.testing.assert_array_equal(
            bmax[~lk], np.maximum(boxes[c, 3:6], boxes[c, 9:12]))


def phase_lbvh(backend, rays, card_out, stable):
    import jax
    import numpy as np

    from vkrt_jax.accel.lbvh import build_lbvh, morton30

    a = backend.attr_table
    geo = (a[:, 0:3], a[:, 3:6], a[:, 6:9])
    build = jax.jit(build_lbvh)
    t0 = time.perf_counter()
    gpu = jax.block_until_ready(build(*geo))
    build_s = time.perf_counter() - t0
    check_lbvh(gpu)
    cpu_dev = jax.devices("cpu")[0]
    cpu = jax.block_until_ready(build(*jax.device_put(geo, cpu_dev)))

    @jax.jit
    def codes(v0, e1, e2):
        c = v0 + (e1 + e2) / 3.0
        return morton30(c, c.min(axis=0), c.max(axis=0))

    kg = np.asarray(codes(*geo))
    kc = np.asarray(codes(*jax.device_put(geo, cpu_dev)))
    same_tree = all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(gpu, cpu))
    t, tri, occ = trace_on_card(jax.device_put(cpu, jax.devices()[0]),
                                *rays)
    tg, trig, occg = card_out
    diff = (tri != trig) | (occ != occg) | (t != tg)
    cst, ost = stable
    bad = int(((tri != trig) & cst).sum() + ((occ != occg) & ost).sum())
    log(f"phase 4: LBVH build on the card {build_s:.2f} s (incl. compile);"
        f" invariants hold; Morton keys differing card vs host: "
        f"{int((kg != kc).sum())} of {kg.size}; trees identical: "
        f"{same_tree}; rays answering differently through the two trees:"
        f" {int(diff.sum())} (on certified rays: {bad})")
    assert bad == 0
    log("phase 4 ok")


def phase_golden():
    from vkrt_jax.golden.harness import golden_gate

    m = golden_gate()
    log(f"phase 5: golden 640x480 reference workload: rmse_stable "
        f"{m['rmse_stable']:.3e} stable_frac {m['stable_frac']:.4f} "
        f"rmse_trimmed {m['rmse_trimmed']:.3e} flip_frac "
        f"{m['flip_frac']:.3e} (raw rmse {m['rmse']:.3e})")
    assert not m["failures"], m["failures"]
    log("phase 5 ok")


def rot_y(ang, shift=(0.0, 0.0, 0.0)):
    import numpy as np

    c, s = np.cos(ang), np.sin(ang)
    m = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                 np.float32)
    m[:3, 3] = shift
    return m


def phase_config5():
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.wavefront.engine import Renderer

    cfg = C.config5_stress()
    cam = contract_camera(cfg.width, cfg.height)
    static = Renderer(C.DEFAULT_SCENE,
                      dataclasses.replace(cfg, rebuild_per_frame=False))
    fb_static, rays_static = static.render(cam)
    r = Renderer(C.DEFAULT_SCENE, cfg)
    t0 = time.perf_counter()
    frames = [r.render(cam, transform=m) for m in
              (np.eye(4, dtype=np.float32), rot_y(0.02),
               rot_y(-0.03, (0.05, 0.0, -0.05)))]
    dt = time.perf_counter() - t0
    for fb, _ in frames:
        assert np.isfinite(fb).all()
    same = np.array_equal(frames[0][0], fb_static)
    moved = float(np.abs(frames[1][0] - fb_static).mean())
    log(f"phase 6: config 5 three rebuilt frames {dt:.1f} s (incl. "
        f"compile); identity frame == static frame: {same} (rays "
        f"{frames[0][1]} vs {rays_static}); rotated frame mean|d| "
        f"{moved:.4f}")
    assert same and frames[0][1] == rays_static and moved > 0
    log("phase 6 ok")


def phase_raster(flat, model):
    import jax.numpy as jnp
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.app.framebuffer import rmse
    from vkrt_jax.golden.raster_oracle import render_golden_raster
    from vkrt_jax.raster import Rasterizer, render_raster_frame
    from vkrt_jax.scene import build_texture_heap

    cfg = dataclasses.replace(C.reference_config(), width=800, height=600)
    r = Rasterizer(C.DEFAULT_SCENE, cfg, msaa=8)
    fb = r.render(contract_camera(800, 600), show_fps=False)
    assert fb.shape == (600, 800, 3) and np.isfinite(fb).all()
    small = dataclasses.replace(cfg, width=160, height=120)
    cam = contract_camera(160, 120)
    got = np.asarray(render_raster_frame(
        r.backend, r.tex, jnp.asarray(cam.proj_inverse),
        jnp.asarray(cam.view_inverse), small, msaa=8))
    want = render_golden_raster(flat, build_texture_heap(model.images),
                                cam.proj_inverse, cam.view_inverse, small,
                                msaa=8, accel="native")
    err = rmse(got, want)
    log(f"phase 7: raster 800x600 8xMSAA finite; 160x120 8xMSAA vs raster "
        f"oracle rmse {err:.3e} (bar 1e-3)")
    assert err <= 1e-3
    log("phase 7 ok")


def phase_multi():
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vkrt_jax import config as C
    from vkrt_jax.parallel.mesh import make_mesh, render_frame_sharded
    from vkrt_jax.wavefront.engine import load_scene_assets, render_frame

    devs = jax.devices()
    assert len(devs) >= 4, f"--multi needs 4 devices, found {devs}"
    mesh = make_mesh(devs[:4])
    cfg = C.config4_flythrough()
    cam = contract_camera(cfg.width, cfg.height)
    _, tex, be = load_scene_assets(C.DEFAULT_SCENE)
    args = (be, tex, jnp.asarray(cam.proj_inverse),
            jnp.asarray(cam.view_inverse), jnp.asarray(C.LIGHT_POSITIONS))
    one = jax.jit(functools.partial(render_frame, cfg=cfg))
    four = jax.jit(functools.partial(render_frame_sharded, cfg=cfg,
                                     mesh=mesh))
    fb1, rays1 = (np.asarray(x) for x in one(*args))
    fb4, rays4 = (np.asarray(x) for x in four(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(one(*args))
    t1 = time.perf_counter()
    jax.block_until_ready(four(*args))
    t4 = time.perf_counter()
    diff = np.abs(fb4 - fb1).max(axis=-1)
    err = float(diff.max())
    log(f"multi: config 4 on a 4-card mesh vs one card: max|d| {err:.3e} "
        f"({int((diff > 1e-5).sum())} of {diff.size} pixels over 1e-5), "
        f"rays {int(rays4.sum())} vs {int(rays1.sum())}; frame "
        f"{(t4 - t1) * 1e3:.1f} ms on 4 cards, {(t1 - t0) * 1e3:.1f} ms "
        f"on 1")
    assert err <= 1e-5 and int(rays4.sum()) == int(rays1.sum())
    log("multi ok")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="only the 4-card sharded frame vs one card")
    args = p.parse_args(argv)

    devs = require_gpu()
    card = card_info()
    log(f"phase 1: card {card}; jax.devices() {devs}; JAX_PLATFORMS="
        f"{os.environ.get('JAX_PLATFORMS')!r}")

    from vkrt_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    t_start = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        from vkrt_jax import config as C
        from vkrt_jax.wavefront.engine import Renderer, cached_model

        t0 = time.perf_counter()
        renderer = Renderer(C.DEFAULT_SCENE, C.config4_flythrough(),
                            quantize=True)
        log(f"setup: generated scene + texture heap + LBVH "
            f"{time.perf_counter() - t0:.1f} s")
        phase_frames(renderer, renderer.cfg, card)
        rays, card_out, stable = phase_trace(renderer.flat,
                                             renderer.backend)
        phase_lbvh(renderer.backend, rays, card_out, stable)
        phase_golden()
        phase_config5()
        phase_raster(renderer.flat, cached_model(C.DEFAULT_SCENE))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)


if __name__ == "__main__":
    main()
