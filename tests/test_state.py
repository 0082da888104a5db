"""Checkpoint/resume round-trip."""

import numpy as np

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.app.state import load_state, save_state


def test_state_roundtrip(tmp_path):
    cfg = C.config4_flythrough()
    cam = Camera(cfg.width, cfg.height)
    cam.set_position([1.5, 2.5, -3.0])
    cam.set_rotation([0.1, 0.9, 0.0])
    p = str(tmp_path / "ckpt.json")
    save_state(p, cfg, cam, frame_index=137, extra={"note": "x"})

    cfg2, cam2, idx, extra = load_state(p)
    assert cfg2 == cfg
    assert idx == 137
    assert extra["note"] == "x"
    np.testing.assert_allclose(cam2.position, cam.position)
    np.testing.assert_allclose(cam2.rotation, cam.rotation)
    # resumed camera produces identical matrices
    np.testing.assert_array_equal(cam2.view_matrix, cam.view_matrix)
