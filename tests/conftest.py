"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU; sharding logic is validated the standard way,
on XLA's host-platform device-count override (SURVEY.md §4). Must be set
before JAX initializes a backend. The GPU paths are exercised by
chip_smoke.py and bench.py on the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from vkrt_jax.config import DEFAULT_SCENE  # noqa: E402

# Small textures keep the generated scene cheap on the CPU; every test
# that renders the whole scene uses this size, so the engine's scene
# cache builds it once per worker.
TEXDIM = 64
# A few submeshes in view of the contract camera (columns, an arch, both
# green curtains, the west lion relief and the two chains; ~6.5k
# triangles, metallic reliefs and chains), small enough for the
# brute-force oracle.
SUBSET = (20, 24, 26, 28, 40, 86, 95, 46, 92)


@pytest.fixture(scope="session")
def ref_model():
    from vkrt_jax.scene import load_scene
    return load_scene(DEFAULT_SCENE, max_texture_dim=TEXDIM)


@pytest.fixture(scope="session")
def ref_flat(ref_model):
    from vkrt_jax.scene import flatten_model
    return flatten_model(ref_model)


@pytest.fixture(scope="session")
def ref_heap(ref_model):
    from vkrt_jax.scene import build_texture_heap
    return build_texture_heap(ref_model.images)


@pytest.fixture(scope="session")
def subset_model(ref_model):
    from vkrt_jax.scene.model import Model
    return Model(submeshes=[ref_model.submeshes[i] for i in SUBSET],
                 materials=ref_model.materials, images=ref_model.images)


@pytest.fixture()
def rng():
    # function-scoped: each test gets the same fresh stream, so outcomes
    # never depend on suite order (a shared stream caused a tolerance
    # flake that only appeared in full-suite runs)
    return np.random.default_rng(1234)
