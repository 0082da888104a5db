"""Scene ingest: counts, flattening, texture heap (ref: src/Model.cpp)."""

import numpy as np

from vkrt_jax.config import SCENE_SCALE
from vkrt_jax.scene.textures import build_mip_chain, mip_levels_for


def test_reference_counts(ref_model):
    # SURVEY.md §6: 103 submeshes, 25 materials, 69 images,
    # 262,267 triangles, 192,496 vertices.
    assert len(ref_model.submeshes) == 103
    assert len(ref_model.materials) == 25
    assert len(ref_model.images) == 69
    assert ref_model.num_triangles == 262267
    assert ref_model.num_vertices == 192496


def test_flatten_rebases_indices(ref_flat, ref_model):
    T = ref_flat.num_triangles
    V = ref_flat.num_vertices
    assert T == 262267 and V == 192496
    assert ref_flat.indices.max() < V
    # per-submesh triangle offsets are exclusive-prefix sums
    np.testing.assert_array_equal(
        ref_flat.submesh_tri_offset,
        np.concatenate([[0], np.cumsum(ref_flat.submesh_tri_count)[:-1]]))
    # material fallback quirk: all per-tri image indices >= 0
    assert ref_flat.tri_normal.min() >= 0
    assert ref_flat.tri_metallic_roughness.min() >= 0


def test_flatten_bakes_world_scale(ref_flat):
    mn, mx = ref_flat.aabb
    # the atrium spans ~37 x 15 x 23 m after the 0.01 instance scale
    # (ref: src/Raytracer.cpp:1165-1169)
    ext = mx - mn
    assert 30.0 < ext[0] < 45.0 and 12.0 < ext[1] < 18.0
    assert 18.0 < ext[2] < 28.0
    assert SCENE_SCALE == 0.01


def test_generated_geometry_in_boxes(ref_model):
    from vkrt_jax.scene.generate import _elements
    boxes = [b / SCENE_SCALE for b, _, _ in _elements()]
    for i in (0, 50, 102):
        sm = ref_model.submeshes[i]
        lo, hi = boxes[i]
        assert (sm.positions >= lo - 1e-2).all()
        assert (sm.positions <= hi + 1e-2).all()
        # normals are unit (padded duplicates included)
        n = np.linalg.norm(sm.normals, axis=1)
        np.testing.assert_allclose(n, 1.0, atol=1e-4)


def test_generated_deterministic_per_seed():
    from vkrt_jax.scene import load_scene
    m1 = load_scene("generated", max_texture_dim=8)
    m2 = load_scene("generated:0", max_texture_dim=8)
    m3 = load_scene("generated:5", max_texture_dim=8)
    np.testing.assert_array_equal(m1.submeshes[7].positions,
                                  m2.submeshes[7].positions)
    np.testing.assert_array_equal(m1.submeshes[7].indices,
                                  m2.submeshes[7].indices)
    np.testing.assert_array_equal(m1.images[3].data, m2.images[3].data)
    assert not np.array_equal(m1.submeshes[7].positions,
                              m3.submeshes[7].positions)
    # another seed changes content, never the published shape
    assert m3.num_triangles == 262267 and m3.num_vertices == 192496


def test_generated_textures(ref_model):
    """69 RGBA images at max_texture_dim; some base-colour maps cut alpha
    below the raster discard threshold, some metallic-roughness maps
    carry metallic (blue) above the reflection threshold."""
    from vkrt_jax import config as C
    from vkrt_jax.raster.pipeline import ALPHA_DISCARD
    for im in ref_model.images:
        assert im.data.shape == (64, 64, 4) and im.data.dtype == np.uint8
    base = {m.base_color for m in ref_model.materials}
    mr = {m.metallic_roughness for m in ref_model.materials}
    alpha_cut = [i for i in base
                 if (ref_model.images[i].data[..., 3] / 255.0
                     < ALPHA_DISCARD).any()]
    metallic = [i for i in mr
                if (ref_model.images[i].data[..., 2] / 255.0
                    > C.METALLIC_THRESHOLD).all()]
    assert len(alpha_cut) >= 2 and len(metallic) >= 3
    assert len(base | mr | {m.normal for m in ref_model.materials}) == 69


def test_contract_camera_hit_fraction(ref_flat):
    """At the contract camera at least 90% of primary rays hit."""
    from vkrt_jax import config as C
    from vkrt_jax.app.camera import Camera
    from vkrt_jax.golden.cpu_tracer import generate_camera_rays
    from vkrt_jax.native import NativeBVH

    idx = ref_flat.indices.astype(np.int64)
    v0 = ref_flat.positions[idx[:, 0]]
    bvh = NativeBVH(v0, ref_flat.positions[idx[:, 1]] - v0,
                    ref_flat.positions[idx[:, 2]] - v0)
    for w, h in ((160, 120), (192, 108)):
        cam = Camera(w, h)
        cam.set_position(C.CAMERA_START_POSITION)
        cam.set_rotation(C.CAMERA_START_ROTATION)
        o, d = generate_camera_rays(w, h, cam.proj_inverse,
                                    cam.view_inverse)
        _, tri, _, _ = bvh.closest(o, d, C.RAY_TMIN, C.RAY_TMAX)
        assert (tri >= 0).mean() >= 0.90


def test_no_two_sheets_coincide():
    """Sheets that share a thin axis and overlap in the other two lie in
    disjoint slabs of it, so no two surfaces coincide (a coincident pair
    makes the closest hit, and any golden comparison, ill-defined)."""
    from vkrt_jax.scene.generate import _elements
    boxes = [b for b, _, _ in _elements()]
    thin = [int(np.argmin(b[1] - b[0])) for b in boxes]
    for i in range(len(boxes)):
        for j in range(i):
            if thin[i] != thin[j]:
                continue
            a, b = boxes[i], boxes[j]
            lo, hi = np.maximum(a[0], b[0]), np.minimum(a[1], b[1])
            others = [k for k in range(3) if k != thin[i]]
            if (hi[others] > lo[others]).all():
                assert hi[thin[i]] <= lo[thin[i]], (i, j)


def test_lights_inside_bounds_outside_geometry(ref_flat):
    """The four lights lie inside the scene bounds and outside every
    submesh's box; so does the contract camera."""
    from vkrt_jax import config as C
    from vkrt_jax.scene.generate import _elements
    lo, hi = ref_flat.aabb
    pts = np.concatenate([C.LIGHT_POSITIONS,
                          np.asarray([C.CAMERA_START_POSITION])])
    assert ((pts > lo) & (pts < hi)).all()
    for box, _, _ in _elements():
        inside = ((pts >= box[0] - 0.05) & (pts <= box[1] + 0.05)).all(1)
        assert not inside.any()


def test_mip_chain():
    img = np.arange(8 * 8 * 4, dtype=np.uint8).reshape(8, 8, 4)
    chain = build_mip_chain(img)
    assert len(chain) == 4  # 8→4→2→1
    assert chain[-1].shape == (1, 1, 4)
    assert mip_levels_for(1024, 1024) == 11
    # box filter correctness on a known block
    flat = np.zeros((2, 2, 4), dtype=np.uint8)
    flat[0, 0] = 100
    flat[0, 1] = 200
    flat[1, 0] = 100
    flat[1, 1] = 200
    out = build_mip_chain(flat)[1]
    assert out[0, 0, 0] == 150


def test_texture_heap_addressing(ref_heap):
    h = ref_heap
    assert h.num_images == 69
    # every level's extent fits inside the heap
    ends = h.level_offset + h.level_width * h.level_height
    assert ends.max() <= h.texels.shape[0]
    # level 0 of image 0 starts at 0
    assert h.level_offset[0, 0] == 0
    # widths halve down the chain
    assert h.level_width[0, 1] == max(1, h.level_width[0, 0] // 2)


def _write_bin_gltf(tmp_path):
    """A tiny glTF with a REAL binary geometry buffer: primitive 0 is a
    z=0 quad with tightly-packed accessors + u16 indices (the widening
    quirk, ref: src/Model.cpp:68-77); primitive 1 is a far-away triangle
    read through an INTERLEAVED byteStride buffer view + native u32
    indices (the strided-accessor path, ref: src/Model.cpp:80-117)."""
    import json
    import struct

    # quad spanning x,y in [-500, 500] model units at z=0 (world +-5
    # after the baked 0.01 TLAS scale)
    pos0 = np.array([[-500, -500, 0], [500, -500, 0],
                     [500, 500, 0], [-500, 500, 0]], np.float32)
    nrm0 = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv0 = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tan0 = np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1))
    idx0 = np.array([0, 1, 2, 0, 2, 3], np.uint16)

    # interleaved POSITION+NORMAL (stride 24), far below the quad
    pos1 = np.array([[-100, -100, -100000], [100, -100, -100000],
                     [0, 100, -100000]], np.float32)
    nrm1 = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
    inter = np.concatenate([pos1, nrm1], axis=1).astype(np.float32)  # [3,6]
    idx1 = np.array([0, 1, 2], np.uint32)

    blobs, views, accessors = [], [], []
    offset = 0

    def add_view(data, stride=None):
        nonlocal offset
        b = data.tobytes()
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(b),
                      **({"byteStride": stride} if stride else {})})
        blobs.append(b)
        offset += len(b)
        return len(views) - 1

    def add_accessor(view, comp, typ, count, byte_offset=0, minmax=None):
        a = {"bufferView": view, "componentType": comp, "type": typ,
             "count": count, "byteOffset": byte_offset}
        if minmax is not None:
            a["min"], a["max"] = minmax
        accessors.append(a)
        return len(accessors) - 1

    v_pos0 = add_view(pos0)
    v_nrm0 = add_view(nrm0)
    v_uv0 = add_view(uv0)
    v_tan0 = add_view(tan0)
    v_idx0 = add_view(idx0)
    v_int = add_view(inter, stride=24)
    v_idx1 = add_view(idx1)

    a_pos0 = add_accessor(v_pos0, 5126, "VEC3", 4,
                          minmax=(pos0.min(0).tolist(), pos0.max(0).tolist()))
    a_nrm0 = add_accessor(v_nrm0, 5126, "VEC3", 4)
    a_uv0 = add_accessor(v_uv0, 5126, "VEC2", 4)
    a_tan0 = add_accessor(v_tan0, 5126, "VEC4", 4)
    a_idx0 = add_accessor(v_idx0, 5123, "SCALAR", 6)
    a_pos1 = add_accessor(v_int, 5126, "VEC3", 3,
                          minmax=(pos1.min(0).tolist(), pos1.max(0).tolist()))
    a_nrm1 = add_accessor(v_int, 5126, "VEC3", 3, byte_offset=12)
    a_idx1 = add_accessor(v_idx1, 5125, "SCALAR", 3)

    from PIL import Image as PILImage
    tex = np.zeros((4, 4, 4), np.uint8)
    tex[..., 0] = 200
    tex[..., 1] = 100
    tex[..., 3] = 255
    PILImage.fromarray(tex).save(tmp_path / "tex.png")

    gltf = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "geom.bin", "byteLength": offset}],
        "bufferViews": views,
        "accessors": accessors,
        "images": [{"uri": "tex.png"}],
        "textures": [{"source": 0}],
        "materials": [{"pbrMetallicRoughness":
                       {"baseColorTexture": {"index": 0}}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": a_pos0, "NORMAL": a_nrm0,
                            "TEXCOORD_0": a_uv0, "TANGENT": a_tan0},
             "indices": a_idx0, "material": 0},
            {"attributes": {"POSITION": a_pos1, "NORMAL": a_nrm1},
             "indices": a_idx1},
        ]}],
    }
    (tmp_path / "geom.bin").write_bytes(b"".join(blobs))
    (tmp_path / "scene.gltf").write_text(json.dumps(gltf))
    return tmp_path / "scene.gltf", (pos0, nrm0, uv0, tan0, idx0,
                                     pos1, nrm1, idx1)


def test_binary_gltf_loads_and_traces(tmp_path):
    """The glTF loader on an actual binary glTF: exact geometry decode
    incl. the strided-view path and u16->u32 widening, then an
    end-to-end trace through the flattened scene."""
    import jax.numpy as jnp

    from vkrt_jax.config import SCENE_SCALE
    from vkrt_jax.scene import flatten_model, load_model
    from vkrt_jax.utils import layout as L
    from vkrt_jax.wavefront.engine import make_backend

    path, (pos0, nrm0, uv0, tan0, idx0, pos1, nrm1, idx1) = \
        _write_bin_gltf(tmp_path)
    model = load_model(str(path))

    sm0, sm1 = model.submeshes
    np.testing.assert_array_equal(sm0.positions, pos0)
    np.testing.assert_array_equal(sm0.normals, nrm0)
    np.testing.assert_array_equal(sm0.uvs, uv0)
    np.testing.assert_array_equal(sm0.tangents, tan0)
    assert sm0.indices.dtype == np.uint32           # u16 widened
    np.testing.assert_array_equal(sm0.indices, idx0.astype(np.uint32))
    np.testing.assert_array_equal(sm1.positions, pos1)  # strided view
    np.testing.assert_array_equal(sm1.normals, nrm1)
    np.testing.assert_array_equal(sm1.indices, idx1)
    assert sm1.material == -1                       # missing-material quirk
    assert len(model.images) == 1 and model.images[0].width == 4

    flat = flatten_model(model)
    assert flat.num_triangles == 3
    # index rebasing: submesh 1's indices offset past submesh 0's verts
    assert flat.indices[2].min() >= 4

    be = make_backend(flat)
    # one lane-block of rays straight down onto the quad from world z=5
    o = jnp.stack([jnp.zeros((1, 128)), jnp.zeros((1, 128)),
                   jnp.full((1, 128), 5.0)])
    d = jnp.stack([jnp.zeros((1, 128)), jnp.zeros((1, 128)),
                   jnp.full((1, 128), -1.0)])
    tmax = jnp.full((1, 128), 1000.0)
    t, u, v, attrs, hit = be.closest(o, d, tmax)
    assert bool(np.asarray(hit).all())
    np.testing.assert_allclose(np.asarray(t), 5.0, atol=1e-4)
    assert SCENE_SCALE == 0.01
