"""Checkpoint / resume for long renders and fly-throughs.

The reference has no persistence of any kind (SURVEY.md §5: camera pose
and key state die with the process, the scene reloads every launch). For
production fly-through/batch rendering this module checkpoints the full
session state — config, camera pose, frame index, RNG-free by design —
as JSON, so an interrupted 240-frame run resumes at the exact frame.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera


def save_state(path: str, cfg: C.RenderConfig, camera: Camera,
               frame_index: int, extra: dict | None = None) -> None:
    state = {
        "version": 1,
        "config": dataclasses.asdict(cfg),
        "camera": {
            "position": camera.position.tolist(),
            "rotation": camera.rotation.tolist(),
            "width": cfg.width,
            "height": cfg.height,
        },
        "frame_index": frame_index,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)      # atomic — a crash never corrupts a checkpoint


def load_state(path: str):
    """Returns (cfg, camera, frame_index, extra)."""
    with open(path) as f:
        state = json.load(f)
    assert state["version"] == 1
    cfg = C.RenderConfig(**state["config"])
    cam = Camera(cfg.width, cfg.height)
    cam.set_position(np.asarray(state["camera"]["position"], np.float32))
    cam.set_rotation(np.asarray(state["camera"]["rotation"], np.float32))
    return cfg, cam, int(state["frame_index"]), state.get("extra", {})
