"""Opacity-mask bake for alpha-tested geometry (a copy of
niagara_tpu/cooker/opacity.py: `bake_mesh_masks` :39, `bake_opacity` :128).

Each meshlet triangle of an alpha-tested mesh gets an 8x8 bitmask over its
uv-space AABB plus the AABB itself; at raster time the interpolated uv maps
to a cell with two multiplies and the bit gates coverage.

The mask row layout is 8 f32 lanes (all values exact in f32):
  [0:4] mask 64 bits as four 16-bit halves (bit b = cell (b>>3, b&7) opaque)
  [4]   u0   [5] v0    (uv AABB origin)
  [6]   8/du [7] 8/dv  (cell scale; 0 => no alpha test, always opaque)
"""

from __future__ import annotations

import numpy as np

from ..scene import unpack_meshlet_refs


def bake_mesh_masks(uv: np.ndarray, tris_uv_idx: np.ndarray, alpha_mip: np.ndarray,
                    threshold: float = 0.5) -> np.ndarray:
    """Bake mask rows for a [T,3] triangle list with per-corner uv indices.

    Returns [T, 8] f32 rows in the module-level layout.  A cell is opaque
    if ANY texel its uv rect touches passes the alpha threshold — evaluated
    EXACTLY with a summed-area table over the thresholded alpha plane
    (tiled-wrap inclusion/exclusion, O(1) per cell), so thin features —
    1-texel stems, wires — are never missed regardless of the triangle's uv
    extent, and no pixel whose texel is opaque can ever be discarded
    (tests/test_alpha_fidelity.py).  This replaced an adaptive dense point
    sampler that cost ~2e9 samples (~80 s host) on the 1M-draw bench bake."""
    T = len(tris_uv_idx)
    out = np.zeros((T, 8), np.float32)
    if T == 0:
        return out

    tuv = uv[tris_uv_idx]  # [T,3,2]
    h, w = alpha_mip.shape[:2]
    u0 = tuv[..., 0].min(axis=1)
    v0 = tuv[..., 1].min(axis=1)
    u1 = tuv[..., 0].max(axis=1)
    v1 = tuv[..., 1].max(axis=1)
    # extents are floored at one texel (stored in the runtime scale too, so
    # bake cells and runtime cell lookup stay consistent): keeps every cell's
    # texel rect non-empty and edge spacing exactly representable
    du = np.maximum(u1 - u0, 1.0 / w)
    dv = np.maximum(v1 - v0, 1.0 / h)
    opq = (alpha_mip[..., 3].astype(np.float32) / 255.0) >= threshold
    sat = np.zeros((h + 1, w + 1), np.int32)
    np.cumsum(np.cumsum(opq, axis=0), axis=1, out=sat[1:, 1:])
    total = np.int32(sat[h, w])
    col_full = sat[h, :].copy()  # [w+1]: opaque count, x in [0,rx), full height
    row_full = sat[:, w].copy()  # [h+1]: opaque count, y in [0,ry), full width

    # texel index ranges per cell: cell c covers uv [edge[c], edge[c+1]) —
    # half-open on the right, matching the runtime cell lookup
    # floor((u-u0)*8/du) — so the touched texels are the half-open index
    # range [floor(edge[c]*w), ceil(edge[c+1]*w)).  Edge coords are clipped
    # to +-2^27 texels so all downstream arithmetic fits i32 (a cell
    # spanning >2^27 texels wraps the whole texture many times over; the
    # clipped count still reports any-opaque correctly).
    ru = np.clip(np.nan_to_num((u0[:, None] + du[:, None] * (np.arange(9) / 8.0)) * w),
                 -(1 << 27), 1 << 27)
    rv = np.clip(np.nan_to_num((v0[:, None] + dv[:, None] * (np.arange(9) / 8.0)) * h),
                 -(1 << 27), 1 << 27)

    def edge_terms(e, n, col):
        """For [T,9] integer texel coords: (q, A, rowf-or-colf, r) [T,9] i32."""
        q, r = np.divmod(e, n)
        q = q.astype(np.int32)
        r = r.astype(np.intp)
        return q, col[r], r

    qxl, Al, rxl = edge_terms(np.floor(ru).astype(np.int64), w, col_full)
    qxh, Ah, rxh = edge_terms(np.ceil(ru).astype(np.int64), w, col_full)
    qyl, Bl, ryl = edge_terms(np.floor(rv).astype(np.int64), h, row_full)
    qyh, Bh, ryh = edge_terms(np.ceil(rv).astype(np.int64), h, row_full)
    Al = qxl * total + Al  # A(X) = qx*total + colf(rx)
    Ah = qxh * total + Ah

    # F(X,Y) = qy*A(X) + qx*rowf(ry) + sat[ry,rx].  Per cell (xlo from the
    # floor-edge c, xhi from the ceil-edge c+1, same for y) the double
    # difference decomposes into two [T,8]x[T,8] outer products plus a
    # 4-corner sat gather — all contiguous i32 (strided i64 broadcast
    # arithmetic is ~100x slower in this numpy).
    dA = np.ascontiguousarray(Ah[:, 1:] - Al[:, :-1])  # [T,8] per u-cell
    dqx = np.ascontiguousarray(qxh[:, 1:] - qxl[:, :-1])
    dB = np.ascontiguousarray(Bh[:, 1:] - Bl[:, :-1])  # [T,8] per v-cell
    dqy = np.ascontiguousarray(qyh[:, 1:] - qyl[:, :-1])
    flat = sat.ravel()
    xl, xh = rxl[:, None, :-1], rxh[:, None, 1:]
    yl, yh = ryl[:, :-1, None] * (w + 1), ryh[:, 1:, None] * (w + 1)
    ddG = (flat[(yh + xh).ravel()] - flat[(yh + xl).ravel()]
           - flat[(yl + xh).ravel()] + flat[(yl + xl).ravel()]).reshape(T, 8, 8)
    cnt = dqy[:, :, None] * dA[:, None, :] + dqx[:, None, :] * dB[:, :, None] + ddG
    cells = cnt > 0  # [T, vcell, ucell]

    bits = cells.reshape(T, 64).astype(np.uint64) << np.arange(64, dtype=np.uint64)[None, :]
    mask = bits.sum(axis=1, dtype=np.uint64)
    for h in range(4):
        out[:, h] = ((mask >> np.uint64(16 * h)) & np.uint64(0xFFFF)).astype(np.float32)
    out[:, 4] = u0
    out[:, 5] = v0
    out[:, 6] = 8.0 / du
    out[:, 7] = 8.0 / dv
    return out


def bake_opacity(geometry, draws, materials: dict | None, texture_mips: list | None,
                 threshold: float = 0.5) -> np.ndarray | None:
    """Scene-level bake: mask rows for every meshlet triangle of every mesh
    referenced by an alpha-tested draw (postPass == 1).

    `texture_mips`: list of per-texture mip lists ([h,w,4] u8), indexed by
    the RAW material texture ids (materials["textures"], -1 = none — the +1
    shift to the device texture table happens at upload).  Returns
    [M, 96, 8] f32 (zero rows = no alpha test) or None when nothing is
    alpha-tested."""
    if materials is None or texture_mips is None:
        return None
    post = np.asarray(draws.post_pass)
    alpha_draws = np.nonzero(post == 1)[0]
    if len(alpha_draws) == 0:
        return None

    mat_tex = np.asarray(materials["textures"])  # [NM,4], albedo at col 0
    mesh_mat = {}
    for d in alpha_draws:
        mesh_mat[int(draws.mesh_index[d])] = int(draws.material_index[d])

    vertex_ids, tris = unpack_meshlet_refs(geometry)
    M = len(tris)
    out = np.zeros((M, 96, 8), np.float32)

    m = geometry.meshes
    uv = geometry.vuv.astype(np.float32)
    tri_counts = np.asarray(geometry.meshlets.triangle_count)
    for mesh, mat in mesh_mat.items():
        tex_id = int(mat_tex[mat, 0])
        if tex_id < 0 or tex_id >= len(texture_mips):
            continue
        # bake from mip 1 when available (reference uses OMMMIP default 1,
        # niagara.cpp:872: half-res alpha is stabler and 4x cheaper)
        mips = texture_mips[tex_id]
        mip = mips[min(1, len(mips) - 1)]
        # batch every meshlet triangle of this mesh into ONE bake call (a
        # per-meshlet loop pays the vectorized machinery's setup 1000s of
        # times over; at 1M-draw bench scale that was ~80 s of host time)
        mls, slots, corners = [], [], []
        for lod in range(int(m.lod_count[mesh])):
            mo = int(m.lod_meshlet_offset[mesh, lod])
            mc = int(m.lod_meshlet_count[mesh, lod])
            for ml in range(mo, mo + mc):
                tcnt = int(tri_counts[ml])
                mls.append(np.full(tcnt, ml, np.int64))
                slots.append(np.arange(tcnt, dtype=np.int64))
                corners.append(vertex_ids[ml][tris[ml, :tcnt]])  # [t,3] global verts
        if not mls:
            continue
        mls = np.concatenate(mls)
        slots = np.concatenate(slots)
        corners = np.concatenate(corners, axis=0)
        out[mls, slots] = bake_mesh_masks(uv, corners, mip, threshold)
    return out
