"""Flatten a Model into global SoA arrays for the device.

Behavioral port of the reference's merged-buffer construction
(ref: src/Raytracer.cpp:642-742): per-submesh indices are rebased into one
global u32 index stream over one merged vertex buffer, and a per-submesh
info table records texture indices + triangle offsets
(ref: src/Raytracer.cpp:1412-1427, consumed by shader.rchit:88-92 as
`materialIndexBuffer[gl_GeometryIndexEXT]`).

Differences by design:
  * the per-submesh texture-index lookup is pre-expanded into per-*triangle*
    material arrays (one gather at shade time instead of
    triangle→submesh→material double indirection);
  * the TLAS instance transform — a uniform 0.01 scale
    (ref: src/Raytracer.cpp:1165-1169) — is baked into the vertex positions,
    so all ray math runs directly in world space (exactly equivalent for a
    single static uniformly-scaled instance; see accel/ for the per-frame
    rebuild path used by the stress config).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vkrt_jax.config import SCENE_SCALE
from vkrt_jax.scene.model import Model


@dataclasses.dataclass
class FlatScene:
    # geometry (world space, scale baked)
    positions: np.ndarray        # f32[V,3]
    normals: np.ndarray          # f32[V,3]
    uvs: np.ndarray              # f32[V,2]
    tangents: np.ndarray         # f32[V,4]
    indices: np.ndarray          # u32[T,3] — global, rebased
    # per-triangle material info (expanded from the submesh info table)
    tri_base_color: np.ndarray   # i32[T] image index
    tri_metallic_roughness: np.ndarray  # i32[T]
    tri_normal: np.ndarray       # i32[T]
    tri_submesh: np.ndarray      # i32[T] — gl_GeometryIndexEXT analogue
    # per-submesh table (parity with SubmeshInfo, ref: Raytracer.cpp:33-39)
    submesh_tri_offset: np.ndarray      # i32[S] — indexBufferOffset in tris
    submesh_tri_count: np.ndarray       # i32[S]
    submesh_base_color: np.ndarray      # i32[S]
    submesh_metallic_roughness: np.ndarray  # i32[S]
    submesh_normal: np.ndarray          # i32[S]

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def aabb(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)


def flatten_model(model: Model, scale: float = SCENE_SCALE) -> FlatScene:
    positions, normals, uvs, tangents = [], [], [], []
    indices = []
    sub_off, sub_cnt, sub_bc, sub_mr, sub_nm = [], [], [], [], []

    vertex_base = 0
    tri_offset = 0
    for sm in model.submeshes:
        positions.append(sm.positions * np.float32(scale))
        normals.append(sm.normals)
        uvs.append(sm.uvs)
        tangents.append(sm.tangents)
        # index rebasing, ref: src/Raytracer.cpp:670-689
        indices.append(sm.indices.astype(np.uint32).reshape(-1, 3) + np.uint32(vertex_base))
        vertex_base += sm.num_vertices

        mat = model.materials[sm.material] if sm.material >= 0 else None
        bc = mat.base_color if mat else -1
        mr = mat.metallic_roughness if mat else -1
        nm = mat.normal if mat else -1
        # missing normal/MR maps fall back to image 0 — quirk preserved
        # (ref: src/Raytracer.cpp:1424-1426 `std::max(index, 0)`)
        mr = max(mr, 0)
        nm = max(nm, 0)
        # intentional deviation: the reference does NOT clamp base_color
        # (a materialless submesh would index UB there); clamping to image
        # 0 keeps the lookup in-bounds, like the safe-normalize deviation
        bc = max(bc, 0)
        sub_off.append(tri_offset)
        sub_cnt.append(sm.num_triangles)
        sub_bc.append(bc)
        sub_mr.append(mr)
        sub_nm.append(nm)
        tri_offset += sm.num_triangles

    indices = np.concatenate(indices, axis=0)
    sub_cnt_arr = np.asarray(sub_cnt, dtype=np.int32)
    tri_submesh = np.repeat(np.arange(len(model.submeshes), dtype=np.int32), sub_cnt_arr)

    return FlatScene(
        positions=np.concatenate(positions).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        tangents=np.concatenate(tangents).astype(np.float32),
        indices=indices,
        tri_base_color=np.asarray(sub_bc, dtype=np.int32)[tri_submesh],
        tri_metallic_roughness=np.asarray(sub_mr, dtype=np.int32)[tri_submesh],
        tri_normal=np.asarray(sub_nm, dtype=np.int32)[tri_submesh],
        tri_submesh=tri_submesh,
        submesh_tri_offset=np.asarray(sub_off, dtype=np.int32),
        submesh_tri_count=sub_cnt_arr,
        submesh_base_color=np.asarray(sub_bc, dtype=np.int32),
        submesh_metallic_roughness=np.asarray(sub_mr, dtype=np.int32),
        submesh_normal=np.asarray(sub_nm, dtype=np.int32),
    )
