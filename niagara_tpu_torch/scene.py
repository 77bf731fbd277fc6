"""Scene data model, JAX-free.

Mirrors niagara_tpu/scene.py: the host-side cooked arrays (`Geometry`,
`Draws`, numpy SoA) and the static-shape device layout (`DeviceScene`).
`upload` builds the layout in numpy exactly as the reference's `upload`
does (scene.py:381) for every field the port reads, materials, opacity
masks and texture metadata included; `from_numpy` turns that layout -- or
the reference's own numpy `DeviceScene` -- into tensors on one device.

Not mirrored: the TPU-only `meshlet_setup_row` (bf16-split channel rows for
the Pallas setup kernel's DMA) and `meshlet_cull_blocks` (64-meshlet cull
blocks of the legacy wavefront cull).  The CUDA setup kernel reads
`meshlet_vdata` in f32 directly.  Vertex-level tables (`positions`,
`normals`, `uvs`, `tangents`) join with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .config import MESH_MAXTRI, MESH_MAXVTX
from .utils import math3d


@dataclass
class Meshlets:
    """SoA meshlet headers (field-for-field niagara_tpu.scene.Meshlets)."""

    center: np.ndarray  # f32 [M,3]
    radius: np.ndarray  # f32 [M]
    cone_axis: np.ndarray  # i8 [M,3]
    cone_cutoff: np.ndarray  # i8 [M]
    data_offset: np.ndarray  # u32 [M]
    base_vertex: np.ndarray  # u32 [M]
    vertex_count: np.ndarray  # u8 [M]
    triangle_count: np.ndarray  # u8 [M]
    short_refs: np.ndarray  # u8 [M]

    @property
    def count(self) -> int:
        return len(self.radius)


@dataclass
class Meshes:
    """SoA mesh headers + LOD tables (field-for-field niagara_tpu.scene.Meshes)."""

    center: np.ndarray  # f32 [N,3]
    radius: np.ndarray  # f32 [N]
    vertex_offset: np.ndarray  # u32 [N]
    vertex_count: np.ndarray  # u32 [N]
    lod_count: np.ndarray  # u32 [N]
    lod_rt: np.ndarray  # u32 [N]
    lod_index_offset: np.ndarray  # u32 [N, MAX_LODS]
    lod_index_count: np.ndarray  # u32 [N, MAX_LODS]
    lod_meshlet_offset: np.ndarray  # u32 [N, MAX_LODS]
    lod_meshlet_count: np.ndarray  # u32 [N, MAX_LODS]
    lod_error: np.ndarray  # f32 [N, MAX_LODS]

    @property
    def count(self) -> int:
        return len(self.radius)


@dataclass
class Geometry:
    """Cooked geometry for a whole scene (field-for-field niagara_tpu.scene.Geometry)."""

    vpos: np.ndarray  # f16 [V,3]
    vnorm: np.ndarray  # u32 [V] packed 10-10-10-2 normal + bitangent sign
    vtan: np.ndarray  # u16 [V]
    vuv: np.ndarray  # f16 [V,2]
    indices: np.ndarray  # u32 [I] LOD-concatenated index buffer
    meshlet_data: np.ndarray  # u32 [D] packed vertex refs + triangle bytes
    meshlets: Meshlets
    meshes: Meshes

    @property
    def vertex_count(self) -> int:
        return len(self.vpos)


@dataclass
class Draws:
    """SoA draw instances (field-for-field niagara_tpu.scene.Draws)."""

    position: np.ndarray  # f32 [N,3]
    scale: np.ndarray  # f32 [N]
    orientation: np.ndarray  # f32 [N,4] quaternion xyzw
    mesh_index: np.ndarray  # i32 [N]
    meshlet_visibility_offset: np.ndarray  # u32 [N]
    post_pass: np.ndarray  # i32 [N]
    material_index: np.ndarray  # i32 [N]

    @property
    def count(self) -> int:
        return len(self.scale)


@dataclass
class DeviceScene:
    """Static-shape scene layout.  `upload` fills it with numpy arrays,
    `from_numpy` with tensors on one device (same field names and dtypes
    as niagara_tpu.scene.DeviceScene)."""

    meshlet_vertices: object  # i32 [M, 64] absolute vertex ids
    meshlet_tris: object  # i32 [M, 96, 3] meshlet-local corner ids
    meshlet_vdata: object  # f32 [M, 64, 8] position, object normal, uv
    meshlet_cull_row: object  # f32 [M, 8] center, radius, cone axis, cutoff
    meshlet_triangle_count: object  # i32 [M]
    draw_position: object  # f32 [D,3]
    draw_scale: object  # f32 [D]
    draw_orientation: object  # f32 [D,4]
    draw_mesh_index: object  # i32 [D]
    draw_vis_offset: object  # i32 [D]
    draw_post_pass: object  # i32 [D]
    draw_material_index: object  # i32 [D]
    draw_mesh_row: object  # f32 [D, 5+MAX_LODS] center, radius, lod count, lod errors
    draw_lod_meshlet_count: object  # i32 [D, MAX_LODS]
    draw_lod_meshlet_offset: object  # i32 [D, MAX_LODS]
    draw_xform_row: object  # f32 [D, 8] position, scale, quaternion
    # opacity masks, channel-major [Ma, 8, 128]: 4 mask halves + uv rect per
    # meshlet triangle (lanes 96-127 zero); one zero row without masks
    meshlet_alpha: object  # f32 [Ma, 8, 128]
    mat_diffuse: object  # f32 [NM,4]
    mat_specular: object  # f32 [NM,4]
    mat_emissive: object  # f32 [NM,3]
    mat_textures: object  # i32 [NM,4] albedo/normal/specular/emissive, 1-based table ids (0 = none)
    # material megarow: 0-3 diffuse, 4-7 specular, 8-10 emissive, 11-14 tex
    # ids, 15 albedo mip-0 texel area, 16-19 albedo addressing metadata
    # (mip-0 pool offset, w, h, mip count)
    mat_row: object  # f32 [NM, 20]
    meshlet_visibility_count: int = 0
    has_alpha_masks: bool = False  # meshlet_alpha holds baked masks
    texture_slots: tuple = (False, False, False, False)  # material slots any material textures
    has_texture_meta: bool = False  # mat_row cols 16-19 come from a texture table

    @property
    def num_draws(self) -> int:
        return len(self.draw_scale)

    @property
    def num_meshlets(self) -> int:
        return len(self.meshlet_triangle_count)


_STATIC_FIELDS = ("meshlet_visibility_count", "has_alpha_masks", "texture_slots", "has_texture_meta")
_ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(DeviceScene) if f.name not in _STATIC_FIELDS)


def assign_meshlet_visibility_offsets(draws: Draws, meshes: Meshes) -> int:
    """Per-draw offsets into the persistent meshlet-visibility bitfield,
    each draw's slot range rounded up to 64 (scene.py:118).  Returns the
    total slot count."""
    per_mesh = np.max(meshes.lod_meshlet_count, axis=1)
    per_draw = (per_mesh[draws.mesh_index] + 63) // 64 * 64
    offsets = np.zeros(draws.count, dtype=np.uint32)
    if draws.count:
        np.cumsum(per_draw[:-1], out=offsets[1:])
    draws.meshlet_visibility_offset = offsets.astype(np.uint32)
    return int(per_draw.sum()) if draws.count else 0


def unpack_meshlet_refs(geometry: Geometry) -> tuple[np.ndarray, np.ndarray]:
    """Packed meshlet data -> (vertex_ids [M,64] i32 absolute, tris
    [M,96,3] i32 meshlet-local); padding is zeros (scene.py:136)."""
    ml = geometry.meshlets
    M = ml.count
    data = geometry.meshlet_data
    vertex_ids = np.zeros((M, MESH_MAXVTX), dtype=np.int32)
    tris = np.zeros((M, MESH_MAXTRI, 3), dtype=np.int32)
    data_u16 = data.view(np.uint16)
    data_u8 = data.view(np.uint8)
    for m in range(M):
        off = int(ml.data_offset[m])
        vcnt = int(ml.vertex_count[m])
        tcnt = int(ml.triangle_count[m])
        if ml.short_refs[m]:
            refs = data_u16[off * 2 : off * 2 + vcnt].astype(np.int32)
            index_off = off + (vcnt + 1) // 2
        else:
            refs = data[off : off + vcnt].astype(np.int32)
            index_off = off + vcnt
        vertex_ids[m, :vcnt] = refs + int(ml.base_vertex[m])
        tris[m, :tcnt] = data_u8[index_off * 4 : index_off * 4 + tcnt * 3].astype(np.int32).reshape(tcnt, 3)
    return vertex_ids, tris


def _albedo_area_column(materials: dict, texture_table) -> np.ndarray:
    """[NM, 1] f32: each material's albedo mip-0 texel area (w*h), 1 when
    untextured or without a table (scene.py:342)."""
    col = np.ones((len(materials["diffuse"]), 1), np.float32)
    if texture_table is None:
        return col
    ids = np.asarray(materials["textures"])[:, 0] + 1  # 1-based table ids
    mw, mh = np.asarray(texture_table.mip_w), np.asarray(texture_table.mip_h)
    ok = (ids > 0) & (ids < len(mw))
    safe = np.where(ok, ids, 0)
    col[:, 0] = np.where(ok, (mw[safe, 0] * mh[safe, 0]).astype(np.float32), 1.0)
    return col


def _albedo_meta_columns(materials: dict, texture_table) -> np.ndarray:
    """[NM, 4] f32: each material's albedo addressing metadata (mip-0 pool
    offset, w, h, mip count) for textures.sample's `meta` path
    (scene.py:358); a 1x1 one-mip dummy without a table."""
    cols = np.zeros((len(materials["diffuse"]), 4), np.float32)
    cols[:, 1:4] = 1.0
    if texture_table is None:
        return cols
    ids = np.asarray(materials["textures"])[:, 0] + 1
    ok = (ids > 0) & (ids < len(texture_table.mip_count))
    safe = np.where(ok, ids, 0)
    cols[:, 0] = texture_table.mip_offset[safe, 0]
    cols[:, 1] = texture_table.mip_w[safe, 0]
    cols[:, 2] = texture_table.mip_h[safe, 0]
    cols[:, 3] = texture_table.mip_count[safe]
    return cols


def upload(geometry: Geometry, draws: Draws, materials: dict | None = None,
           alpha_masks: np.ndarray | None = None, texture_table=None) -> DeviceScene:
    """numpy device layout from cooked geometry + draws (scene.py:381).
    Absent `materials`, one matte-white material, as in the reference.
    `alpha_masks` [M,96,8] (cooker.opacity.bake_opacity) enables the alpha
    test of post-pass-1 draws; `texture_table` (render.textures, host
    side) bakes each material's albedo mip metadata into `mat_row`."""
    vis_count = assign_meshlet_visibility_offsets(draws, geometry.meshes)
    vertex_ids, tris = unpack_meshlet_refs(geometry)
    assert vertex_ids.max(initial=0) < (1 << 24), "vertex ids must stay exact in f32 records"
    if materials is None:
        materials = {
            "diffuse": np.array([[1.0, 1.0, 1.0, 1.0]], dtype=np.float32),
            "specular": np.zeros((1, 4), dtype=np.float32),
            "emissive": np.zeros((1, 3), dtype=np.float32),
        }
    if "textures" not in materials:
        materials = dict(materials, textures=np.full((len(materials["diffuse"]), 4), -1, dtype=np.int32))
    M = len(tris)
    if alpha_masks is not None:
        meshlet_alpha = np.zeros((M, 8, 2 * MESH_MAXVTX), np.float32)
        meshlet_alpha[:, :, :MESH_MAXTRI] = np.transpose(alpha_masks.astype(np.float32), (0, 2, 1))
    else:
        meshlet_alpha = np.zeros((1, 8, 2 * MESH_MAXVTX), np.float32)
    tex_ids = materials["textures"].astype(np.int32) + 1  # 1-based table ids, 0 = none

    positions = geometry.vpos.astype(np.float32)
    normals = math3d.unpack_normal(geometry.vnorm)
    uvs = geometry.vuv.astype(np.float32)
    ml, me = geometry.meshlets, geometry.meshes
    mesh = draws.mesh_index
    return DeviceScene(
        meshlet_vertices=vertex_ids,
        meshlet_tris=tris,
        meshlet_vdata=np.concatenate([positions[vertex_ids], normals[vertex_ids], uvs[vertex_ids]], axis=-1),
        meshlet_cull_row=np.concatenate(
            [
                ml.center.astype(np.float32),
                ml.radius.astype(np.float32)[:, None],
                ml.cone_axis.astype(np.float32) / 127.0,
                ml.cone_cutoff.astype(np.float32)[:, None] / 127.0,
            ],
            axis=1,
        ),
        meshlet_triangle_count=ml.triangle_count.astype(np.int32),
        draw_position=draws.position.astype(np.float32),
        draw_scale=draws.scale.astype(np.float32),
        draw_orientation=draws.orientation.astype(np.float32),
        draw_mesh_index=mesh.astype(np.int32),
        draw_vis_offset=draws.meshlet_visibility_offset.astype(np.int32),
        draw_post_pass=draws.post_pass.astype(np.int32),
        draw_material_index=draws.material_index.astype(np.int32),
        draw_mesh_row=np.concatenate(
            [
                me.center.astype(np.float32)[mesh],
                me.radius.astype(np.float32)[mesh, None],
                me.lod_count.astype(np.float32)[mesh, None],
                me.lod_error.astype(np.float32)[mesh],
            ],
            axis=-1,
        ),
        draw_lod_meshlet_count=me.lod_meshlet_count.astype(np.int32)[mesh],
        draw_lod_meshlet_offset=me.lod_meshlet_offset.astype(np.int32)[mesh],
        draw_xform_row=np.concatenate(
            [
                draws.position.astype(np.float32),
                draws.scale.astype(np.float32)[:, None],
                draws.orientation.astype(np.float32),
            ],
            axis=-1,
        ),
        meshlet_alpha=meshlet_alpha,
        mat_diffuse=materials["diffuse"].astype(np.float32),
        mat_specular=materials["specular"].astype(np.float32),
        mat_emissive=materials["emissive"].astype(np.float32),
        mat_textures=tex_ids,
        mat_row=np.concatenate(
            [
                materials["diffuse"].astype(np.float32),
                materials["specular"].astype(np.float32),
                materials["emissive"].astype(np.float32),
                tex_ids.astype(np.float32),
                _albedo_area_column(materials, texture_table),
                _albedo_meta_columns(materials, texture_table),
            ],
            axis=-1,
        ),
        meshlet_visibility_count=vis_count,
        has_alpha_masks=alpha_masks is not None,
        texture_slots=tuple(bool((materials["textures"][:, i] >= 0).any()) for i in range(4)),
        has_texture_meta=texture_table is not None,
    )


def from_numpy(np_scene, device) -> DeviceScene:
    """Tensors on `device` from a numpy scene layout: this module's `upload`
    output or niagara_tpu.scene.upload's (fields are read by name)."""
    return DeviceScene(
        **{
            name: torch.from_numpy(np.ascontiguousarray(getattr(np_scene, name))).to(device)
            for name in _ARRAY_FIELDS
        },
        meshlet_visibility_count=int(np_scene.meshlet_visibility_count),
        has_alpha_masks=bool(np_scene.has_alpha_masks),
        texture_slots=tuple(bool(x) for x in np_scene.texture_slots),
        has_texture_meta=bool(np_scene.has_texture_meta),
    )
