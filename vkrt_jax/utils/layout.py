"""Lane-major data layouts for per-ray state.

Per-ray state is struct-of-arrays: every component is a contiguous
[Nb, 128] plane, so elementwise ops read whole rows and 128-lane groups
map to spatially tight 8x16-pixel subtiles (wavefront/engine.tile).

Canonical layouts here:
  scalar per ray  → f32[Nb, 128]      ("lanes", Nb = N/128, zero padding)
  vector per ray  → f32[3, Nb, 128]   ("cvec", component-major)

N must be a multiple of 128 (the engine's 512-ray blocks guarantee it).
"""

from __future__ import annotations

import jax.numpy as jnp

LANES = 128


def to_lanes(x):
    """[N] → [Nb, 128]."""
    return x.reshape(-1, LANES)


def from_lanes(x):
    """[Nb, 128] → [N]."""
    return x.reshape(-1)


def to_cvec(x):
    """[N, 3] → [3, Nb, 128]."""
    return jnp.moveaxis(x.reshape(-1, LANES, x.shape[-1]), -1, 0)


def from_cvec(v):
    """[3, Nb, 128] → [N, 3]."""
    return jnp.moveaxis(v, 0, -1).reshape(-1, v.shape[0])


# --- componentwise vector math over cvecs --------------------------------

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return jnp.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]])


def scale3(a, s):
    """cvec * per-ray scalar."""
    return a * s[None]


def norm3(a):
    return jnp.sqrt(jnp.maximum(dot3(a, a), 0.0))


def normalize3(a, eps: float = 1e-20):
    return a / jnp.maximum(norm3(a), eps)[None]


def where3(mask, a, b):
    """select per ray: mask [Nb,128], cvecs a/b."""
    return jnp.where(mask[None], a, b)


def mat_rows3(x, m):
    """Row-vector transform y[..., i] = sum_j x[..., j] * m[i, j]
    (x: [..., 3], m: [R, 3] -> y: [..., R]) as EXPLICIT elementwise
    f32 math. jnp.einsum / `@` with a 3-wide contraction lowers to a
    matrix product that may run in TF32 (about three decimal digits) on
    the GPU's tensor cores — a device-only wrongness no CPU test sees
    (tests/test_matmul_precision_guard.py). This form stays exact f32."""
    return (x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1]
            + x[..., 2:3] * m[:, 2])
