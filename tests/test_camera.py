"""Camera math vs the glm behavioral contract (ref: src/Camera.cpp)."""

import numpy as np

from vkrt_jax.app.camera import Camera
from vkrt_jax.config import (CAMERA_START_POSITION, CAMERA_START_ROTATION,
                             REF_HEIGHT, REF_WIDTH)
from vkrt_jax.utils import mathutils as mu


def make_ref_camera():
    cam = Camera(REF_WIDTH, REF_HEIGHT)
    cam.set_position(CAMERA_START_POSITION)
    cam.set_rotation(CAMERA_START_ROTATION)
    return cam


def test_identity_rotation_basis():
    cam = Camera()
    np.testing.assert_allclose(cam.forward, [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(cam.left, [-1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(cam.up, [0, 1, 0], atol=1e-6)


def test_start_pose_faces_negative_x():
    # rotation (0, 1.57, 0) — yaw ~90° → forward ≈ -X (ref: Raytracer.cpp:267-271)
    cam = make_ref_camera()
    f = cam.forward
    assert f[0] < -0.999
    assert abs(f[1]) < 1e-6


def test_view_inverse_roundtrip():
    cam = make_ref_camera()
    vi = cam.view_inverse
    # viewInverse * (0,0,0,1) = camera position (ref: shader.rgen:38)
    origin = vi @ np.array([0, 0, 0, 1], dtype=np.float32)
    np.testing.assert_allclose(origin[:3], CAMERA_START_POSITION, atol=1e-5)


def test_projection_quirk_45_radians():
    # glm::perspective(45.0f) receives radians → tan(22.5 rad) ≈ 0.55743
    cam = Camera(REF_WIDTH, REF_HEIGHT)
    p = cam.projection_matrix
    expected = 1.0 / np.tan(45.0 / 2.0)
    assert np.isclose(p[1, 1], -expected, rtol=1e-6)  # Y-flip applied
    assert np.isclose(p[0, 0], expected / (REF_WIDTH / REF_HEIGHT), rtol=1e-6)


def test_center_ray_matches_forward():
    # The rgen-generated center-pixel ray must align with camera forward.
    cam = make_ref_camera()
    pi, vi = cam.proj_inverse, cam.view_inverse
    # center pixel → uvNorm = (0,0)+epsilon; use exact center
    target = pi @ np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)
    d = mu.normalize(target[:3])
    world_dir = (vi @ np.append(d, 0.0).astype(np.float32))[:3]
    cosang = np.dot(mu.normalize(world_dir), cam.forward)
    assert cosang > 0.9999


def test_translate_rotate_contract():
    cam = Camera()
    cam.rotate([0, 1, 0], 1.5 * 0.1)  # Z key, rotationSpeed*dt (ref: Raytracer.cpp:313-317)
    assert np.isclose(cam.rotation[1], 0.15)
    f0 = cam.forward
    cam.translate(f0 * 5.0 * 0.1)     # W key (ref: Raytracer.cpp:290-293)
    np.testing.assert_allclose(cam.position, f0 * 0.5, atol=1e-6)
