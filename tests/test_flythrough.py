"""Scripted fly-through path semantics (ref fly controls, Raytracer.cpp:273-324)."""

import numpy as np

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.app.flythrough import DEFAULT_PATH, apply_keys, camera_path


def test_path_yields_independent_snapshots():
    cams = list(camera_path(64, 48))
    assert len(cams) == sum(f for _, f in DEFAULT_PATH) == 240
    # poses must differ along the path (regression: a mutated shared object)
    p0 = cams[0].position
    p_mid = cams[120].position
    p_end = cams[-1].position
    assert not np.allclose(p0, p_mid)
    assert not np.allclose(p_mid, p_end)


def test_key_speeds_match_reference():
    # W for 1s at dt=1/60 moves exactly translationSpeed units forward
    cam = Camera(64, 48)
    cam.set_rotation([0.0, 0.0, 0.0])
    for _ in range(60):
        apply_keys(cam, "w", 1.0 / 60.0)
    np.testing.assert_allclose(cam.position, [0, 0, -C.TRANSLATION_SPEED],
                               atol=1e-4)
    # Z for 1s rotates rotationSpeed radians about +Y
    cam2 = Camera(64, 48)
    for _ in range(60):
        apply_keys(cam2, "z", 1.0 / 60.0)
    np.testing.assert_allclose(cam2.rotation, [0, C.ROTATION_SPEED, 0],
                               atol=1e-4)
