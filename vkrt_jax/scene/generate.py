"""Seeded reference scene: a Sponza-shaped atrium built in code.

The reference renders Crytek Sponza (SURVEY.md §6). This module builds a
scene with the same published shape from a seed, so the system needs no
asset on disk:

  * 103 submeshes, 262,267 triangles, 192,496 vertices (exact),
  * 25 materials over 69 RGBA images (25 base colour, 22
    metallic-roughness, 22 normal maps), 1024x1024 each, or
    `max_texture_dim` when smaller,
  * an atrium of about 37 x 15 x 23 m after the 0.01 instance scale:
    marble nave floor, stone aisles, outer and end walls, two storeys of
    arcade columns and arches, gallery floors, aisle ceilings, roofs
    over the aisles (the nave is open to the sky), curtains, planters
    with alpha-cut foliage, hanging chains, bronze lion reliefs, banners
    and a door.

Every submesh is one undulating sheet from `synth._grid_patch` laid in
its box. Triangles are budgeted by area; each sheet's vertex grid is
complete and the few triangles left over are zero-area pads, which the
intersectors reject. Vertices beyond a sheet's grid are unreferenced
duplicates, as in the reference's split-by-material buffers.

At the contract camera (config.CAMERA_START_*) most primary rays hit;
the four lights (config.LIGHT_POSITIONS) lie in the open nave; the nave
floor, chains and reliefs are metallic (blue channel > 0.1), so
reflections run; the foliage and chain maps cut alpha below 0.1, so the
raster path's alpha discard runs.
"""

from __future__ import annotations

import numpy as np

from vkrt_jax.config import SCENE_SCALE
from vkrt_jax.scene.model import Image, Material, Model
from vkrt_jax.scene.synth import _grid_patch

NUM_SUBMESHES = 103
NUM_TRIANGLES = 262_267
NUM_VERTICES = 192_496
NUM_MATERIALS = 25
NUM_IMAGES = 69
TEXTURE_DIM = 1024

# --- layout (metres, world space; model units = metres / SCENE_SCALE) ----
X_WEST, X_EAST = -18.8, 17.6      # end walls
Z_OUT = 11.2                      # outer walls at +-Z_OUT
Z_NAVE = 4.5                      # arcades at +-Z_NAVE
Y_GALLERY = 6.0                   # gallery floor
Y_ROOF = 14.3                     # aisle roofs / wall tops
COLUMNS_X = [-14.7 + 4.0 * k for k in range(8)]
COLUMN_HALF = 0.5

# (name, texture kind, base rgb, metallic) per material; MR and normal
# maps: materials 22-24 reuse those of materials of the same kind
# (25 + 22 + 22 = 69 images)
MATERIALS = [
    ("nave_marble", "marble", (0.82, 0.80, 0.74), 0.4),
    ("aisle_stone", "tiles", (0.55, 0.50, 0.44), 0.0),
    ("wall_brick", "brick", (0.62, 0.42, 0.32), 0.0),
    ("wall_plaster", "plaster", (0.78, 0.72, 0.62), 0.0),
    ("column_stone", "stone", (0.70, 0.66, 0.58), 0.0),
    ("column_upper", "stone", (0.66, 0.60, 0.52), 0.0),
    ("arch_stone", "brick", (0.72, 0.64, 0.54), 0.0),
    ("arch_upper", "brick", (0.68, 0.58, 0.50), 0.0),
    ("roof_tiles", "tiles", (0.45, 0.28, 0.22), 0.0),
    ("ceiling_wood", "wood", (0.46, 0.32, 0.20), 0.0),
    ("gallery_floor", "tiles", (0.60, 0.56, 0.50), 0.0),
    ("curtain_red", "fabric", (0.62, 0.10, 0.08), 0.0),
    ("curtain_green", "fabric", (0.12, 0.45, 0.16), 0.0),
    ("curtain_blue", "fabric", (0.12, 0.20, 0.58), 0.0),
    ("foliage", "foliage", (0.20, 0.48, 0.14), 0.0),
    ("chain", "chain", (0.36, 0.34, 0.32), 0.8),
    ("lion_bronze", "bronze", (0.55, 0.38, 0.18), 0.6),
    ("clerestory", "plaster", (0.74, 0.70, 0.64), 0.0),
    ("end_wall", "brick", (0.58, 0.46, 0.38), 0.0),
    ("vase", "stone", (0.52, 0.30, 0.20), 0.0),
    ("trim", "stone", (0.80, 0.76, 0.68), 0.0),
    ("banner", "fabric", (0.70, 0.55, 0.12), 0.0),
    ("door_wood", "wood", (0.36, 0.22, 0.12), 0.0),
    ("relief_panel", "stone", (0.76, 0.74, 0.70), 0.0),
    ("banner_dark", "fabric", (0.30, 0.10, 0.30), 0.0),
]
_SHARED_MAPS = {22: 9, 23: 4, 24: 11}


def _elements():
    """(box [2,3] in metres, material, facing) per submesh. `facing` is
    the sign along the sheet's thin axis its normals take; 0 = toward
    the nave centre."""
    els = []

    def add(x, y, z, mat, facing=0):
        els.append((np.array([[x[0], y[0], z[0]], [x[1], y[1], z[1]]],
                             np.float64), mat, facing))

    # Perpendicular sheets overlap by 0.1 m at their seams, so no ray
    # slips through a crack; coplanar neighbours only abut (no sheet
    # coincides). The -z aisle floor runs on under the whole nave, a
    # floor below the floor, so rays a normal map reflects downward stay
    # inside; the +z aisle floor lies lower still where they overlap.
    xs = (X_WEST - 0.10, X_EAST + 0.10)
    zo, zn = Z_OUT + 0.10, Z_NAVE - 0.10
    add(xs, (-0.10, 0.0), (-Z_NAVE, Z_NAVE), 0, +1)              # nave floor
    for sz in (-1, 1):
        zr = tuple(sorted((sz * zn, sz * zo)))
        if sz < 0:                                               # aisle floors
            add(xs, (-0.25, -0.15), (-zo, Z_NAVE + 0.10), 1, +1)
        else:
            add(xs, (-0.40, -0.30), zr, 1, +1)
        add(xs, (Y_GALLERY - 0.25, Y_GALLERY - 0.15), zr, 9, -1)  # ceiling
        add(xs, (Y_GALLERY, Y_GALLERY + 0.10), zr, 10, +1)        # gallery
        add(xs, (Y_ROOF, Y_ROOF + 0.10), zr, 8, -1)               # roof
        wall = tuple(sorted((sz * Z_OUT, sz * (Z_OUT + 0.10))))
        add(xs, (-0.45, Y_GALLERY), wall, 2)                      # outer wall
        add(xs, (Y_GALLERY, Y_ROOF + 0.20), wall, 3)
        arc = tuple(sorted((sz * (Z_NAVE - 0.06), sz * (Z_NAVE + 0.06))))
        add(xs, (10.5, Y_ROOF + 0.20), arc, 17)                   # clerestory
        for k, cx in enumerate(COLUMNS_X):
            add((cx - COLUMN_HALF, cx + COLUMN_HALF), (-0.20, Y_GALLERY),
                arc, 4)
            add((cx - COLUMN_HALF, cx + COLUMN_HALF), (Y_GALLERY, 10.5),
                arc, 5)
            if k + 1 < len(COLUMNS_X):
                gap = (cx + COLUMN_HALF, COLUMNS_X[k + 1] - COLUMN_HALF)
                add(gap, (4.3, Y_GALLERY), arc, 6)                # arches
                add(gap, (9.3, 10.5), arc, 7)
        trim = tuple(sorted((sz * (Z_OUT - 0.25), sz * (Z_OUT - 0.10))))
        add(xs, (5.5, Y_GALLERY - 0.30), trim, 20)
        cur = tuple(sorted((sz * 3.6, sz * 4.1)))
        for k, mat in zip((1, 3, 5), (11, 12, 13)):
            mid = 0.5 * (COLUMNS_X[k] + COLUMNS_X[k + 1])
            add((mid - 1.2, mid + 1.2), (2.8, 9.8), cur, mat)     # curtains
        for x0 in (-16.8, 15.2):                                  # planters
            pz = tuple(sorted((sz * 3.2, sz * 3.3)))
            add((x0, x0 + 1.0), (0.0, 1.2), pz, 19)
            fz = tuple(sorted((sz * 3.0, sz * 3.2)))
            add((x0 - 0.5, x0 + 1.5), (1.2, 3.2), fz, 14)
        add((-4.15, -3.85), (9.0, Y_ROOF), (sz * 2.0 - 0.02, sz * 2.0 + 0.02),
            15)                                                   # chain
    for x_wall, sx in ((X_WEST, -1), (X_EAST, 1)):
        wx = tuple(sorted((x_wall, x_wall + sx * 0.10)))
        add(wx, (-0.45, Y_GALLERY), (-zo, zo), 18)                # end walls
        add(wx, (Y_GALLERY, Y_ROOF + 0.20), (-zo, zo), 18)
        rx = tuple(sorted((x_wall - sx * 0.25, x_wall - sx * 0.55)))
        add(rx, (1.0, 3.0), (-1.2, 1.2), 16)                      # lion relief
        bx = tuple(sorted((x_wall - sx * 0.12, x_wall - sx * 0.22)))
        add(bx, (7.0, 12.0), (-2.0, 2.0), 21 if sx < 0 else 24)   # banners
    add((X_EAST - 0.30, X_EAST - 0.15), (0.0, 3.5), (5.8, 8.2), 22)  # door
    add((X_WEST + 0.15, X_WEST + 0.30), (0.5, 4.0), (6.0, 9.0), 23)  # panel
    return els


def _budgets(els):
    """Vertex grid (rows, cols), triangle and vertex count per element:
    triangles by area^0.75, grids complete, totals exact."""
    ext = np.array([b[1] - b[0] for b, _, _ in els])
    big = np.sort(ext, axis=1)[:, ::-1]              # (u, v, s) extents
    area = big[:, 0] * big[:, 1]
    w = area ** 0.75
    quads = np.maximum(150, w / w.sum() * (NUM_TRIANGLES // 2 * 0.995))
    grids = []
    for q, (eu, ev) in zip(quads, big[:, :2]):
        cols = max(2, int(np.sqrt(q * eu / ev)) + 1)
        rows = max(2, int(q / (cols - 1)) + 1)
        grids.append([rows, cols])
    tris = lambda g: 2 * (g[0] - 1) * (g[1] - 1)
    left = NUM_TRIANGLES - sum(tris(g) for g in grids)
    assert left >= 0
    # grow grids by whole rows/columns, largest sheets first
    grew = True
    while grew:
        grew = False
        for i in np.argsort(-area):
            g = grids[i]
            for add in ((1, 0), (0, 1)):
                d = 2 * (g[1] - 1) if add[0] else 2 * (g[0] - 1)
                if d <= left:
                    g[0] += add[0]
                    g[1] += add[1]
                    left -= d
                    grew = True
    n_tris = [tris(g) for g in grids]
    n_tris[-1] += left                               # zero-area pads
    used = np.array([g[0] * g[1] for g in grids])
    spare = NUM_VERTICES - used.sum()
    assert spare >= 0
    pad = np.floor(spare * used / used.sum()).astype(int)
    pad[-1] += spare - pad.sum()
    return grids, n_tris, (used + pad).tolist()


# --- textures ------------------------------------------------------------

def _wave(rng, u, v, n: int, fmax: int):
    """Tileable sum of n random integer-frequency sinusoids, in [-1, 1]."""
    acc = np.zeros_like(u)
    amp_sum = 0.0
    for _ in range(n):
        fu, fv = rng.integers(-fmax, fmax + 1, size=2)
        fu = fu or 1
        a = rng.uniform(0.3, 1.0) / np.hypot(fu, fv)
        acc += a * np.sin(2 * np.pi * (fu * u + fv * v)
                          + rng.uniform(0, 2 * np.pi))
        amp_sum += a
    return acc / amp_sum


def _pattern(kind: str, rng, u, v):
    """(albedo scale in [0,1], height field, alpha) for a texture kind."""
    noise = _wave(rng, u, v, 6, 12)
    ones = np.ones_like(u)
    if kind == "brick":
        row = np.floor(v * 16)
        bu = u * 8 + 0.5 * (row % 2)
        mortar = (np.mod(v * 16, 1) < 0.08) | (np.mod(bu, 1) < 0.04)
        h = np.where(mortar, 0.0, 1.0)
        return np.where(mortar, 0.55, 0.9 + 0.1 * noise), h, ones
    if kind in ("tiles", "marble"):
        n = 4 if kind == "marble" else 8
        groove = (np.mod(u * n, 1) < 0.03) | (np.mod(v * n, 1) < 0.03)
        checker = (np.floor(u * n) + np.floor(v * n)) % 2
        vein = 0.5 + 0.5 * np.sin(2 * np.pi * (3 * u + 2 * v) + 3 * noise)
        alb = 0.8 + 0.1 * checker + 0.1 * vein ** 8
        return np.where(groove, 0.6, alb), np.where(groove, 0.0, 1.0), ones
    if kind == "wood":
        grain = 0.5 + 0.5 * np.sin(2 * np.pi * (24 * v + 2 * noise))
        return 0.75 + 0.25 * grain, grain, ones
    if kind == "fabric":
        weave = np.sin(2 * np.pi * 64 * u) * np.sin(2 * np.pi * 64 * v)
        stripe = np.sin(2 * np.pi * 8 * u)
        return 0.8 + 0.1 * stripe + 0.05 * weave, 0.5 + 0.5 * weave, ones
    if kind == "foliage":
        leaves = _wave(rng, u, v, 8, 10)
        alpha = np.where(leaves > 0.05, 1.0, 0.0)
        return 0.7 + 0.3 * leaves, leaves, alpha
    if kind == "chain":
        link = np.abs(np.sin(2 * np.pi * 8 * v)) * np.abs(
            np.sin(np.pi * (2 * u)))
        alpha = np.where(link > 0.35, 1.0, 0.0)
        return 0.8 + 0.2 * link, link, alpha
    # stone / plaster / bronze: smooth noise
    return 0.85 + 0.15 * noise, 0.5 + 0.5 * noise, ones


def _u8(x):
    return np.clip(np.asarray(x) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _material_images(rng, dim: int, kind: str, rgb, metallic: float):
    """(base colour, metallic-roughness, normal map) u8[dim,dim,4]."""
    g = (np.arange(dim, dtype=np.float32) + 0.5) / dim
    u, v = np.meshgrid(g, g)
    albedo, height, alpha = _pattern(kind, rng, u, v)
    tint = np.asarray(rgb, np.float32) * rng.uniform(0.95, 1.05, 3)
    base = np.concatenate([np.clip(albedo[..., None] * tint, 0, 1),
                           alpha[..., None]], axis=-1)
    rough = 0.5 + 0.3 * _wave(rng, u, v, 3, 4)
    mr = np.stack([np.ones_like(u), rough, np.full_like(u, metallic),
                   np.ones_like(u)], axis=-1)
    # tangent-space normal from the height field's wrapped gradient (in
    # uv units, so the relief does not depend on the resolution), its
    # slope capped at 0.3 (about 17 degrees of tilt)
    hx = (np.roll(height, -1, axis=1) - np.roll(height, 1, axis=1)) * dim
    hy = (np.roll(height, -1, axis=0) - np.roll(height, 1, axis=0)) * dim
    sx = np.clip(-0.01 * hx, -0.3, 0.3)
    sy = np.clip(-0.01 * hy, -0.3, 0.3)
    n = np.stack([sx, sy, np.ones_like(u)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nmap = np.concatenate([n * 0.5 + 0.5, np.ones_like(u)[..., None]],
                          axis=-1)
    return _u8(base), _u8(mr), _u8(nmap)


def generate_model(seed: int = 0, max_texture_dim: int = 0) -> Model:
    """The seeded reference scene as a Model (positions in model units)."""
    rng = np.random.default_rng(seed)
    els = _elements()
    assert len(els) == NUM_SUBMESHES
    grids, n_tris, n_verts = _budgets(els)
    inv = 1.0 / SCENE_SCALE
    submeshes = []
    for (box, mat, facing), grid, nt, nv in zip(els, grids, n_tris,
                                               n_verts):
        ext = box[1] - box[0]
        s_ax = int(np.argmin(ext))
        if facing == 0:   # toward the nave centre line
            facing = 1 if box.mean(axis=0)[s_ax] < (
                5.0 if s_ax == 1 else 0.0) else -1
        big = np.sort(ext)[::-1]
        rep = (max(1.0, round(big[0] / 2.0)), max(1.0, round(big[1] / 2.0)))
        sm = _grid_patch(rng, nv, nt, (box[0] * inv).astype(np.float32),
                         (box[1] * inv).astype(np.float32), grid=tuple(grid),
                         uv_repeat=rep, facing=facing)
        sm.material = mat
        submeshes.append(sm)

    dim = min(TEXTURE_DIM, max_texture_dim) if max_texture_dim \
        else TEXTURE_DIM
    base, mr, nrm = [], [], []
    for i, (_, kind, rgb, metallic) in enumerate(MATERIALS):
        b, m, n = _material_images(rng, dim, kind, rgb, metallic)
        base.append(b)
        if i not in _SHARED_MAPS:
            mr.append(m)
            nrm.append(n)
    n_maps = len(mr)
    materials = []
    for i in range(NUM_MATERIALS):
        j = _SHARED_MAPS.get(i, i)
        materials.append(Material(base_color=i,
                                  metallic_roughness=NUM_MATERIALS + j,
                                  normal=NUM_MATERIALS + n_maps + j))
    images = [Image(width=dim, height=dim, data=d)
              for d in base + mr + nrm]
    return Model(submeshes=submeshes, materials=materials, images=images)
