"""Device runtime: info, frame pacing."""

import jax.numpy as jnp
import numpy as np

from vkrt_jax.runtime import FrameScheduler, device_info


def test_device_info():
    info = device_info()
    assert info["num_devices"] == 8  # virtual CPU mesh from conftest
    assert info["platform"] == "cpu"


def test_frame_scheduler_pacing():
    import jax

    calls = []

    @jax.jit
    def frame(i):
        return i * 2.0

    sched = FrameScheduler(inflight=2)
    retired = []
    for i in range(6):
        r = sched.submit(frame, jnp.float32(i))
        if r is not None:
            retired.append(r)
    retired.extend(sched.drain())
    # all 6 frames retire exactly once, in order
    assert [idx for idx, _ in retired] == list(range(6))
    assert all(float(v) == 2.0 * idx for idx, v in retired)
