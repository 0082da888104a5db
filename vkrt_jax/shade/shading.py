"""Hit shading — vectorized port of the closest-hit shader contract.

Implements shaders/shader.rchit:86-172 over ray batches: barycentric
attribute interpolation, TBN normal mapping (tangent.w handedness unused —
quirk preserved, shader.rchit:78-84), the 4-light diffuse loop with
10/d² falloff and hard-shadow multiplier 0.3, 0.1 unattenuated ambient,
and the metallic-reflection rule (blue channel > 0.1 → reflectAmount =
0.5·metallic, attenuation updated BEFORE hitValue is scaled).

Lane-major layouts (utils/layout.py): scalars [Nb,128], vectors/cvecs
[3,Nb,128], uv pairs [2,Nb,128], attrs [36,Nb,128].

Intentional deviation, documented: zero-length vectors safe-normalize
(GLSL normalize(0) is undefined; one Sponza primitive lacks tangents).
"""

from __future__ import annotations

import jax.numpy as jnp

from vkrt_jax import config as C
from vkrt_jax.utils import layout as L

safe_normalize = L.normalize3


def interpolate(attrs, u, v):
    """Split the per-corner attr block [36,Nb,128] and interpolate.

    Row layout is engine.triangle_attrs's:
    0-2 v0, 3-5 e1, 6-8 e2, 9-11 n0, 12-14 n1, 15-17 n2, 18-19 uv0,
    20-21 uv1, 22-23 uv2, 24-26 t0, 27-29 t1, 30-32 t2, 33 material
    slot, 34-35 metallic-roughness / normal image ids.

    Returns (position, normal, uv, tangent, mat_ids). Position is the
    barycentric reconstruction v0 + u·e1 + v·e2 ≡ w·p0 + u·p1 + v·p2 —
    exactly the interpolation the reference shader performs
    (shader.rchit:94-103) rather than origin + t·dir.
    """
    w = 1.0 - u - v
    position = attrs[0:3] + u[None] * attrs[3:6] + v[None] * attrs[6:9]
    normal = attrs[9:12] * w[None] + attrs[12:15] * u[None] + attrs[15:18] * v[None]
    uv = attrs[18:20] * w[None] + attrs[20:22] * u[None] + attrs[22:24] * v[None]
    tangent = attrs[24:27] * w[None] + attrs[27:30] * u[None] + attrs[30:33] * v[None]
    mat_ids = attrs[33:36].astype(jnp.int32)
    return position, normal, uv, tangent, mat_ids


def perturbed_normal(world_normal, tangent, map_normal):
    """TBN normal mapping (ref: shader.rchit:78-84,105-108)."""
    n = L.normalize3(world_normal)
    t = L.normalize3(tangent)
    b = L.cross3(t, n)
    m = L.normalize3(map_normal * 2.0 - 1.0)
    return L.normalize3(t * m[0][None] + b * m[1][None] + n * m[2][None])


def light_geometry(position, light_pos):
    """Per-light direction/distance/power (ref: shader.rchit:121-126).
    position cvec [3,Nb,128]; light_pos [3]. Returns (ldir cvec, ldist,
    power)."""
    lvec = light_pos[:, None, None] - position
    ldist = L.norm3(lvec)
    ldir = lvec / jnp.maximum(ldist, 1e-20)[None]
    power = C.LIGHT_INTENSITY / jnp.maximum(ldist * ldist, 1e-20)
    return ldir, ldist, power


def reflect(d, n):
    """GLSL reflect (ref: shader.rchit:170). cvec in, cvec out."""
    return d - 2.0 * L.dot3(d, n)[None] * n
