"""Scripted fly-through — replaces GLFW WASD/ZC input with a camera path.

Reproduces the reference's fly controls (ref: src/Raytracer.cpp:273-324):
translate 5.0 units/s along camera basis vectors (W/S forward, A/D left,
E/Q up), rotate 1.5 rad/s about world up (Z/C), applied per frame with dt.
A path is a list of (keys, num_frames) segments; the BASELINE config 4
240-frame path is provided as `default_path`.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera

Segment = Tuple[str, int]   # (held keys e.g. "w", frame count)

# 240 frames total — a sweep down the Sponza hall with turns
DEFAULT_PATH: List[Segment] = [
    ("w", 60), ("wz", 40), ("w", 40), ("wc", 40), ("wq", 30), ("ze", 30),
]


def apply_keys(cam: Camera, keys: str, dt: float) -> None:
    """One frame of reference fly-control integration."""
    tr = C.TRANSLATION_SPEED * dt
    rot = C.ROTATION_SPEED * dt
    if "w" in keys:
        cam.translate(cam.forward * tr)
    if "s" in keys:
        cam.translate(-cam.forward * tr)
    if "a" in keys:
        cam.translate(cam.left * tr)
    if "d" in keys:
        cam.translate(-cam.left * tr)
    if "e" in keys:
        cam.translate(cam.up * tr)
    if "q" in keys:
        cam.translate(-cam.up * tr)
    if "z" in keys:
        cam.rotate([0.0, 1.0, 0.0], rot)
    if "c" in keys:
        cam.rotate([0.0, -1.0, 0.0], rot)


def camera_path(width: int, height: int, path: List[Segment] | None = None,
                dt: float = 1.0 / 60.0) -> Iterator[Camera]:
    """Yield a Camera SNAPSHOT per frame along the scripted path (each
    yielded camera is an independent copy — safe to collect into a list)."""
    cam = Camera(width, height)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    for keys, frames in (path or DEFAULT_PATH):
        for _ in range(frames):
            apply_keys(cam, keys, dt)
            snap = Camera(width, height)
            snap.set_position(cam.position)
            snap.set_rotation(cam.rotation)
            yield snap
