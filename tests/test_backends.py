"""Secondary-dispatch re-ordering on the LBVH trace path: the resorted
frames equal the plain ones."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vkrt_jax import config as C
from vkrt_jax.app.camera import Camera
from vkrt_jax.scene import flatten_model
from vkrt_jax.wavefront.engine import (texture_arrays, make_backend,
                                       render_frame)

W, H = 64, 48


@pytest.fixture(scope="module")
def scene(subset_model):
    flat = flatten_model(subset_model)
    tex = texture_arrays(subset_model.images, flat)
    cam = Camera(W, H)
    cam.set_position(C.CAMERA_START_POSITION)
    cam.set_rotation(C.CAMERA_START_ROTATION)
    return make_backend(flat), tex, cam


def test_resort_secondary_matches_unsorted(scene):
    """Secondary-dispatch re-tiling (cfg.resort_secondary: octant
    partition before reflection traces, surface-point-cell partition
    before every shadow dispatch — wavefront/resort.py) permutes each
    dispatch's inputs and inverse-permutes its outputs. Occlusion is
    exactly visit-order independent, so the shadow-only frame must be
    BIT-identical; frames with reflections are allclose — the closest
    hit's NEAR-TIE commits (coincident surfaces / shared edges within
    float rounding) are visit-order dependent at the ~1 ulp level (see
    wavefront/resort.py)."""
    be, tex, cam = scene
    cfg = dataclasses.replace(C.reference_config(), width=W, height=H,
                              resort_secondary=False)
    args = (jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
            jnp.asarray(C.LIGHT_POSITIONS))
    cfg_sh = dataclasses.replace(cfg, enable_reflections=False)
    for base_cfg, exact in ((cfg_sh, True), (cfg, False)):
        cfg_rs = dataclasses.replace(base_cfg, resort_secondary=True)
        fb0, rc0 = render_frame(be, tex, *args, base_cfg)
        fb1, rc1 = render_frame(be, tex, *args, cfg_rs)
        if exact:
            np.testing.assert_array_equal(np.asarray(fb0), np.asarray(fb1))
        else:
            np.testing.assert_allclose(np.asarray(fb0), np.asarray(fb1),
                                       atol=1e-5)
        np.testing.assert_array_equal(np.asarray(rc0), np.asarray(rc1))


def test_group_sort_matches_unsorted(scene):
    """GROUP (128-lane) granularity resort (cfg.group_sort_shadows —
    wavefront/resort.py group_*): whole lane-groups permute by
    mean-surface-point cell via one jnp.take along the Nb axis, masks
    inverse-permuted. Shadow masks are exactly permutation-independent
    (any-hit) → frames BIT-identical."""
    be, tex, cam = scene
    cfg = dataclasses.replace(C.reference_config(), width=W, height=H,
                              group_sort_shadows=False)
    args = (jnp.asarray(cam.proj_inverse), jnp.asarray(cam.view_inverse),
            jnp.asarray(C.LIGHT_POSITIONS))
    cfg_gs = dataclasses.replace(cfg, group_sort_shadows=True)
    fb0, rc0 = render_frame(be, tex, *args, cfg)
    fb1, rc1 = render_frame(be, tex, *args, cfg_gs)
    np.testing.assert_array_equal(np.asarray(fb0), np.asarray(fb1))
    np.testing.assert_array_equal(np.asarray(rc0), np.asarray(rc1))
