"""Device runtime — the Context analogue.

The reference's Context owns instance/device/queue creation, swapchain,
frame pacing and input plumbing (ref: src/Context.{hpp,cpp}, SURVEY.md §2
item 2). The JAX equivalents:

  * device discovery/selection + platform report  (≈ physical-device
    selection, Context.cpp:256-278)
  * persistent compilation cache                  (≈ pipeline caches)
  * FrameScheduler: frames-in-flight pacing — JAX dispatch is async, so
    enqueueing frame N+1 while N executes is the analogue of the
    reference's 3 swapchain images + per-image fences
    (Context.cpp:141-180); `inflight` bounds the queue like the fence
    wait does.

Presentation is headless (app/framebuffer.py) per the BASELINE contract.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Tuple

import numpy as np

from vkrt_jax.utils import get_logger

log = get_logger("vkrt_jax.runtime")


def device_info() -> dict:
    """Platform/device report (≈ the reference's device-name printf,
    VulkanUtils.cpp:34-37)."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform if devs else "none",
        "device_kind": devs[0].device_kind if devs else "none",
        "num_devices": len(devs),
        "default_backend": jax.default_backend(),
    }


def require_gpu():
    """The visible GPU devices; exits non-zero when JAX found none. JAX
    falls back to the CPU when its CUDA plugin fails to start, so a
    measurement that must run on the card checks the platform itself."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU visible to JAX (devices: {devs})")
    return devs


def card_info() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def device_record() -> dict:
    """The device as JAX reports it (platform, kind, count)."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def initialize() -> dict:
    """One-call runtime init: compile cache + device report."""
    from vkrt_jax.utils.cache import enable_compilation_cache

    path = enable_compilation_cache()
    info = device_info()
    log.info("runtime: %s x%d (%s), compile cache at %s",
             info["device_kind"], info["num_devices"], info["platform"], path)
    return info


class FrameScheduler:
    """Frames-in-flight pacing over JAX's async dispatch.

    submit(fn, *args) enqueues a frame (device arrays return immediately);
    when more than `inflight` frames are pending, the oldest is forced to
    completion — exactly the role of the reference's per-image fence wait
    (Context.cpp:141-152). drain() retires everything.
    """

    def __init__(self, inflight: int = 3):   # swapchain depth, VulkanUtils.hpp:26
        self.inflight = inflight
        self._queue: Deque[Tuple[int, object]] = collections.deque()
        self._next = 0

    def submit(self, fn: Callable, *args):
        out = fn(*args)
        self._queue.append((self._next, out))
        self._next += 1
        retired = None
        if len(self._queue) > self.inflight:
            idx, old = self._queue.popleft()
            retired = (idx, self._materialize(old))
        return retired

    @staticmethod
    def _materialize(out):
        import jax
        return jax.tree_util.tree_map(np.asarray, out)

    def drain(self):
        while self._queue:
            idx, out = self._queue.popleft()
            yield idx, self._materialize(out)
