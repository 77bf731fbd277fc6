"""Ray-traced sun shadows (niagara_tpu/ops/shadow.py) and the shadow
term's filters.

The reference traces against a two-level stackless skip-pointer BVH: one
object-space BLAS per mesh at its shadow LOD, built once by the C++
cooker (cooker/native/bvh.cpp), and a TLAS over the instances' world
boxes, rebuilt or refitted on the host when draws move.  `build_scene_rt`
/ `refit_tlas` make the same structure with the port's copy of the
builders; `trace_any_hit` walks it, in csrc/trace.cu's
`trace_any_hit<kAlpha>` for CUDA tensors (persistent warps taking the rays
in `ray_order`'s Morton order) and `trace_plain`, a torch loop that
mirrors the reference's while_loop body op for op, for CPU tensors.
`shadow_pass` is the frame's pipeline: world positions at 1/scale
resolution, a jittered sun direction, a checkerboard of traced pixels,
`checkerboard_fill`, `shadow_blur` and a nearest upsample.

Every float of the walk rounds op by op in both versions (the kernel is
built with --fmad=false), sums of three are written ((a0 + a1) + a2) and
divisions are IEEE, so the kernel's flags equal trace_plain's bit for
bit; XLA:CPU contracts the reference's into FMAs, which may flip a ray
whose hit lies within a few ulp of a triangle edge or a slab face
(tests/test_torch_rt_shadow.py accounts for each).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.profiling import span
from . import cullmath

MAX_LEAF = 8
SHADOW_BLUR_KERNEL = 10
# trace_plain reads back whether any ray is left every this many steps
FROZEN_CHECK = 32
TENSOR_FIELDS = ("nodes", "tri_v0", "tri_e1", "tri_e2", "inst_row", "tri_uv", "tri_alpha")


@dataclass
class ShadowBVH:
    """Two-level scene acceleration structure (shadow.py:41-67), f32
    tensors on one device.  `nodes` holds every BLAS first (skip pointers
    local to each BLAS), then the TLAS from `tlas_base` on (skip pointers
    local to the TLAS), so BLAS offsets stay put across TLAS refits."""

    nodes: torch.Tensor  # [Nb + Nt, 8]: min3, max3, skip and leaf as int32 bits
    tri_v0: torch.Tensor  # [T, 3] object space, BLAS-concatenated, leaf order
    tri_e1: torch.Tensor  # [T, 3] v1 - v0
    tri_e2: torch.Tensor  # [T, 3] v2 - v0
    # per instance, in TLAS leaf order: [0:3] position, [3] scale, [4:8]
    # quaternion xyzw, [8] BLAS node base, [9] BLAS node count, [10] triangle
    # base (exact integers), [11] 0
    inst_row: torch.Tensor  # [D, 12]
    # the quality-1 alpha-tested any-hit's rows (cooker/opacity.py layout):
    # corner uvs u0 v0 u1 v1 u2 v2 and the opacity mask; [1, 8] zeros when
    # untextured
    tri_uv: torch.Tensor  # [Ta, 8]
    tri_alpha: torch.Tensor  # [Ta, 8]
    tlas_base: int = 0

    def to(self, device) -> "ShadowBVH":
        return dataclasses.replace(self, **{f: getattr(self, f).to(device) for f in TENSOR_FIELDS})


def _host_bvh(nodes, tri, inst_row, tri_uv, tri_alpha, tlas_base: int) -> ShadowBVH:
    """ShadowBVH of CPU tensors over numpy arrays (tri: [T, 3, 3] corners)."""
    tri = np.asarray(tri, np.float32)
    arrays = dict(nodes=nodes, tri_v0=tri[:, 0], tri_e1=tri[:, 1] - tri[:, 0], tri_e2=tri[:, 2] - tri[:, 0],
                  inst_row=inst_row, tri_uv=tri_uv, tri_alpha=tri_alpha)
    return ShadowBVH(**{k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in arrays.items()},
                     tlas_base=int(tlas_base))


def from_numpy(fields, device) -> ShadowBVH:
    """The port's ShadowBVH on `device` from an object whose attributes are
    the fields as numpy arrays (or anything np.asarray takes), such as the
    reference's ShadowBVH; the bits are kept (skip and leaf words are NaN
    or denormal floats)."""

    def get(k):
        v = getattr(fields, k, None)
        return np.zeros((1, 8), np.float32) if v is None else np.array(v, dtype=np.float32)

    return ShadowBVH(**{k: torch.from_numpy(get(k)) for k in TENSOR_FIELDS},
                     tlas_base=int(fields.tlas_base)).to(device)


# ------------------------------------------------------------ host build


def _mesh_blas(geometry, mesh_index: int):
    """Object-space BLAS of one mesh at its shadow LOD (shadow.py:70-85):
    (nodes, triangle corners [t, 3, 3], corner indices [t, 3]), leaf order."""
    from ..cooker import bindings

    m = geometry.meshes
    lod = int(m.lod_rt[mesh_index])
    off = int(m.lod_index_offset[mesh_index, lod])
    cnt = int(m.lod_index_count[mesh_index, lod])
    idx = geometry.indices[off:off + cnt].astype(np.uint32)
    positions = geometry.vpos.astype(np.float32)
    nodes, order = bindings.build_bvh(positions, idx)
    tri3 = idx.astype(np.int64).reshape(-1, 3)[order]
    return nodes.astype(np.float32), positions[tri3], tri3


def _instance_world_boxes(roots, orientation, scale, position):
    """Conservative world box of each instance (shadow.py:88-121): for box
    center c and half extents e under rotation R, R c +- |R| e, scaled and
    moved, in the reference's numpy op order."""
    c = ((roots[:, 0:3] + roots[:, 3:6]) * 0.5).astype(np.float32)
    e = ((roots[:, 3:6] - roots[:, 0:3]) * 0.5).astype(np.float32)
    q = np.asarray(orientation, np.float32)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rows = [(1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)),
            (2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)),
            (2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y))]
    s = np.asarray(scale, np.float32)
    p = np.asarray(position, np.float32)
    c0, c1, c2 = c[:, 0], c[:, 1], c[:, 2]
    e0, e1, e2 = e[:, 0], e[:, 1], e[:, 2]
    cw = np.empty_like(c)
    ew = np.empty_like(e)
    for i, (ra, rb, rc) in enumerate(rows):
        cw[:, i] = (ra * c0 + rb * c1 + rc * c2) * s + p[:, i]
        ew[:, i] = (np.abs(ra) * e0 + np.abs(rb) * e1 + np.abs(rc) * e2) * s
    return cw - ew, cw + ew


def build_scene_rt(geometry, draws, materials: dict | None = None, texture_mips: list | None = None):
    """One BLAS per mesh the draws use, then the TLAS over the instances
    (shadow.py:124-222).  Returns (ShadowBVH of CPU tensors, static): pass
    `static` to refit_tlas to redo only the instance level.  With materials
    and texture_mips, the triangles of meshes with an alpha-tested draw
    get their opacity-mask rows (mip 1 of the material's texture) for the
    quality-1 any-hit."""
    mesh_ids = sorted(set(int(m) for m in np.asarray(draws.mesh_index)))
    blas_nodes, blas_base, tri_base, tris, uv_idx = [], {}, {}, [], []
    n_nodes = n_tris = 0
    for mi in mesh_ids:
        nodes, tri, tri3 = _mesh_blas(geometry, mi)
        blas_base[mi] = (n_nodes, len(nodes))
        tri_base[mi] = n_tris
        n_nodes += len(nodes)
        n_tris += len(tri)
        blas_nodes.append(nodes)
        tris.append(tri)
        uv_idx.append(tri3)
    blas = np.concatenate(blas_nodes, axis=0) if blas_nodes else np.zeros((0, 8), np.float32)
    tri = np.concatenate(tris, axis=0) if tris else np.zeros((0, 3, 3), np.float32)

    tri_uv = np.zeros((1, 8), np.float32)
    tri_alpha = np.zeros((1, 8), np.float32)
    if materials is not None and texture_mips is not None and n_tris:
        from ..cooker.opacity import bake_mesh_masks

        uvs = geometry.vuv.astype(np.float32)
        post = np.asarray(getattr(draws, "post_pass", np.zeros(draws.count, np.int32)))
        mat_of_mesh = {int(draws.mesh_index[d]): int(draws.material_index[d]) for d in np.nonzero(post == 1)[0]}
        mat_tex = np.asarray(materials["textures"])
        tri_uv = np.zeros((n_tris, 8), np.float32)
        tri_alpha = np.zeros((n_tris, 8), np.float32)
        for i, mi in enumerate(mesh_ids):
            t3, b = uv_idx[i], tri_base[mi]
            tri_uv[b:b + len(t3), 0:6] = uvs[t3].reshape(-1, 6)
            mat = mat_of_mesh.get(mi)
            if mat is None:
                continue
            tex_id = int(mat_tex[mat, 0])  # raw glTF id, -1 = none
            if tex_id < 0 or tex_id >= len(texture_mips):
                continue
            mips = texture_mips[tex_id]
            tri_alpha[b:b + len(t3)] = bake_mesh_masks(uvs, t3, mips[min(1, len(mips) - 1)])

    static = dict(blas=blas, tri=tri, tri_uv=tri_uv, tri_alpha=tri_alpha, blas_base=blas_base, tri_base=tri_base,
                  blas_roots={mi: blas_nodes[i][0, 0:6] for i, mi in enumerate(mesh_ids)})
    # dense per-mesh tables, so that refit_tlas is vectorized numpy
    max_mesh = max(mesh_ids) + 1 if mesh_ids else 1
    roots_t = np.zeros((max_mesh, 6), np.float32)
    base_t = np.zeros((max_mesh, 2), np.float32)
    trib_t = np.zeros(max_mesh, np.float32)
    for i, mi in enumerate(mesh_ids):
        roots_t[mi] = blas_nodes[i][0, 0:6]
        base_t[mi] = blas_base[mi]
        trib_t[mi] = tri_base[mi]
    static.update(mesh_roots=roots_t, mesh_base=base_t, mesh_tri_base=trib_t)
    return refit_tlas(static, draws), static


def build_scene_bvh(geometry, draws) -> ShadowBVH:
    """The two-level structure of a static scene (shadow.py:225-228)."""
    return build_scene_rt(geometry, draws)[0]


def single_blas(nodes: np.ndarray, tris: np.ndarray) -> ShadowBVH:
    """One object-space BLAS as a scene of one identity instance
    (shadow.py:231-255)."""
    from ..cooker import bindings

    nodes = np.asarray(nodes, np.float32)
    root = nodes[0, 0:6]
    tlas, _ = bindings.build_bvh_boxes(root[None, 0:3], root[None, 3:6], max_leaf=1)
    rows = np.zeros((1, 12), np.float32)
    rows[0, 3] = 1.0  # scale
    rows[0, 7] = 1.0  # quaternion w
    rows[0, 9] = len(nodes)
    zeros = np.zeros((1, 8), np.float32)
    return _host_bvh(np.concatenate([nodes, tlas.astype(np.float32)], axis=0), tris, rows, zeros, zeros, len(nodes))


def refit_tlas(static: dict, draws) -> ShadowBVH:
    """(Re)build the instance level over the BLASes of build_scene_rt's
    `static` (shadow.py:258-309).  Transmission draws get no TLAS leaf.
    The first call for a set of live draws builds the TLAS and keeps its
    topology in static["_tlas"]; later calls for the same set only
    recompute the instance boxes and refit the node boxes bottom-up
    (ck_refit_bvh_boxes), the reference's per-frame MODE_UPDATE."""
    from ..cooker import bindings

    mesh_of_draw = np.asarray(draws.mesh_index).astype(np.int64)
    post = np.asarray(getattr(draws, "post_pass", np.zeros(len(mesh_of_draw), np.int32)))
    live = np.nonzero(post < 2)[0]
    if "mesh_roots" in static:
        mesh_roots, mesh_base, mesh_tri_base = static["mesh_roots"], static["mesh_base"], static["mesh_tri_base"]
    else:  # a static keyed by mesh only (shadow.py:277-286)
        max_mesh = max(static["blas_base"]) + 1
        mesh_roots = np.zeros((max_mesh, 6), np.float32)
        mesh_base = np.zeros((max_mesh, 2), np.float32)
        mesh_tri_base = np.zeros(max_mesh, np.float32)
        for mi, bc in static["blas_base"].items():
            mesh_roots[mi] = static["blas_roots"][mi]
            mesh_base[mi] = bc
            mesh_tri_base[mi] = static["tri_base"][mi]

    cache = static.get("_tlas")
    reuse = cache is not None and np.array_equal(cache["live"], live)
    if len(live):
        sel = cache["ordered"] if reuse else live
        bmin, bmax = _instance_world_boxes(
            mesh_roots[mesh_of_draw[sel]], np.asarray(draws.orientation, np.float32)[sel],
            np.asarray(draws.scale, np.float32)[sel], np.asarray(draws.position, np.float32)[sel])
    else:
        bmin = bmax = np.zeros((0, 3), np.float32)
    if reuse:
        tlas = bindings.refit_bvh_boxes(cache["nodes"], bmin, bmax)
        ordered = cache["ordered"]
    else:
        tlas, order = bindings.build_bvh_boxes(bmin, bmax, max_leaf=1)
        ordered = live[order.astype(np.int64)] if len(live) else np.zeros(0, np.int64)
        static["_tlas"] = dict(nodes=tlas, ordered=ordered, live=live)

    rows = np.zeros((max(len(ordered), 1), 12), np.float32)
    if len(ordered):
        om = mesh_of_draw[ordered]
        rows[:len(ordered), 0:3] = np.asarray(draws.position, np.float32)[ordered]
        rows[:len(ordered), 3] = np.asarray(draws.scale, np.float32)[ordered]
        rows[:len(ordered), 4:8] = np.asarray(draws.orientation, np.float32)[ordered]
        rows[:len(ordered), 8:10] = mesh_base[om]
        rows[:len(ordered), 10] = mesh_tri_base[om]
    nodes = np.concatenate([static["blas"], tlas.astype(np.float32)], axis=0)
    zeros = np.zeros((1, 8), np.float32)
    return _host_bvh(nodes, static["tri"], rows, static.get("tri_uv", zeros), static.get("tri_alpha", zeros),
                     len(static["blas"]))


# ------------------------------------------------------------ the walk


def _safe_inv(d):
    """1 / where(|d| < 1e-12, 1e-12, d), one IEEE division (shadow.py:345):
    a tiny negative component turns into +1e-12, as in the reference."""
    return cullmath.rdiv(1.0, torch.where(torch.abs(d) < 1e-12, 1e-12, d))


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _rotate_conj(v, q):
    """v rotated by the conjugate of quaternion q (world to object,
    shadow.py:312-317)."""
    qv = -q[..., :3]
    t = cullmath.cross(qv, v) + q[..., 3:4] * v
    return v + 2.0 * cullmath.cross(qv, t)


def _max3(t):
    return torch.maximum(torch.maximum(t[..., 0], t[..., 1]), t[..., 2])


def _min3(t):
    return torch.minimum(torch.minimum(t[..., 0], t[..., 1]), t[..., 2])


def _alpha_pass(bvh, ti, u, v):
    """The quality-1 mask test of hits at barycentrics (u, v) on triangles
    ti (shadow.py:403-421): the hit's uv picks a cell of the triangle's
    8x8 mask; its bit is (int(half) >> (cell mod 16)) & 1 of the mask's
    16-bit half the cell lies in (exact integers below 2^16, so the
    reference's floor(half * exp2(-k)) mod 2).  Untextured rows (idu <= 0)
    pass every hit."""
    ta = torch.clamp(ti, max=bvh.tri_alpha.shape[0] - 1)
    arow, uvrow = bvh.tri_alpha[ta], bvh.tri_uv[ta]
    idu = arow[..., 6]
    w = (1.0 - u) - v
    hu = (uvrow[..., 0] * w + uvrow[..., 2] * u) + uvrow[..., 4] * v
    hv = (uvrow[..., 1] * w + uvrow[..., 3] * u) + uvrow[..., 5] * v
    gx = torch.clamp(torch.floor((hu - arow[..., 4]) * idu), 0.0, 7.0)
    gy = torch.clamp(torch.floor((hv - arow[..., 5]) * arow[..., 7]), 0.0, 7.0)
    cell = torch.nan_to_num(gy * 8.0 + gx).to(torch.int32)  # NaN only where the hit test already failed
    half = torch.gather(arow[..., 0:4], -1, (cell >> 4).unsqueeze(-1).long()).squeeze(-1)
    bit = (torch.nan_to_num(half).to(torch.int32) >> (cell & 15)) & 1
    return (idu <= 0.0) | (bit == 1)


def trace_plain(bvh: ShadowBVH, origin, direction, *, t_min: float = 1e-3, t_max: float = 1e30,
                max_steps: int = 1024, alpha_test: bool = False, counters: bool = False):
    """trace_any_hit's loop (shadow.py:320-486) in torch, one iteration of
    the reference's `body` per step for every ray, op for op, frozen rays
    (hit, or walked off the TLAS) keeping their state.  A ray advances
    once per step while unfrozen, so the reference's global step budget is
    a per-ray one.  Every FROZEN_CHECK steps the loop stops early when no
    ray is left (frozen rays never change).

    Returns (occluded bool [N], steps int32 [N]): steps a ray took, -1
    where the budget ran out before its walk ended.  With counters=True
    also a dict of what the kernel fetches: per-ray node rows ("nodes",
    one a step), triangle rows ("tris", a leaf's triangles up to the first
    hit), instance rows ("instances", one per TLAS leaf entered), mask
    tests ("masks", alpha_test: geometric hits, each reading the
    triangle's mask and uv rows), and boolean masks of the distinct rows
    touched ("node_rows", "tri_rows", "inst_rows", "mask_rows")."""
    n, dev = origin.shape[0], origin.device
    nodes = bvh.nodes
    n_nodes, tlas_base = nodes.shape[0], bvh.tlas_base
    tlas_count, n_tris, n_inst = n_nodes - tlas_base, bvh.tri_v0.shape[0], bvh.inst_row.shape[0]
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    hit, steps = torch.zeros(n, dtype=torch.bool, device=dev), zi.clone()
    count_of = dict(nodes=zi.clone(), tris=zi.clone(), instances=zi.clone(), masks=zi.clone(),
                    node_rows=torch.zeros(n_nodes, dtype=torch.bool, device=dev),
                    tri_rows=torch.zeros(n_tris, dtype=torch.bool, device=dev),
                    inst_rows=torch.zeros(n_inst, dtype=torch.bool, device=dev),
                    mask_rows=torch.zeros(bvh.tri_alpha.shape[0], dtype=torch.bool, device=dev))
    if tlas_count == 0 or n_tris == 0:
        return (hit, steps, count_of) if counters else (hit, steps)

    words = nodes[:, 6:8].contiguous().view(torch.int32)
    skip_i, leaf_i = words[:, 0], words[:, 1]
    tri_pack = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], dim=1)
    inv_w = _safe_inv(direction)
    slots = torch.arange(MAX_LEAF, dtype=torch.int32, device=dev)

    ptr, in_blas = zi.clone(), torch.zeros(n, dtype=torch.bool, device=dev)
    base, ncount, tbase = zi.clone(), zi.clone(), zi.clone()
    resume = torch.full((n,), tlas_count, dtype=torch.int32, device=dev)
    o_obj = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d_obj = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for it in range(max_steps):
        frozen = hit | (~in_blas & (ptr >= tlas_count))
        if it % FROZEN_CHECK == 0 and bool(frozen.all()):
            break
        gidx = torch.where(in_blas, base + ptr, tlas_base + torch.clamp(ptr, max=tlas_count - 1))
        gidx = torch.clamp(gidx, 0, n_nodes - 1).long()
        node = nodes[gidx]
        o = torch.where(in_blas[:, None], o_obj, origin)
        d = torch.where(in_blas[:, None], d_obj, direction)
        inv_d = torch.where(in_blas[:, None], _safe_inv(d_obj), inv_w)
        t0 = (node[:, 0:3] - o) * inv_d
        t1 = (node[:, 3:6] - o) * inv_d
        tnear = torch.clamp(_max3(torch.minimum(t0, t1)), min=t_min)
        tfar = torch.clamp(_min3(torch.maximum(t0, t1)), max=t_max)
        box_hit = tnear <= tfar
        leaf, skip = leaf_i[gidx], skip_i[gidx]
        is_leaf = leaf >= 0
        active = ~frozen

        # a BLAS leaf: up to MAX_LEAF watertight any-hit tests, [N, 8] at once
        blas_leaf = active & in_blas & is_leaf & box_hit
        count = torch.where(blas_leaf, leaf & 15, 0)
        ti = torch.clamp((tbase + (leaf >> 4))[:, None] + slots, 0, n_tris - 1).long()
        act = slots < count[:, None]
        trow = tri_pack[ti]
        v0, e1, e2 = trow[..., 0:3], trow[..., 3:6], trow[..., 6:9]
        ds, os_ = d[:, None, :].expand_as(e2), o[:, None, :].expand_as(v0)
        pvec = cullmath.cross(ds, e2)
        det = _dot(e1, pvec)
        inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, cullmath.rdiv(1.0, det))
        tvec = os_ - v0
        u = _dot(tvec, pvec) * inv_det
        qvec = cullmath.cross(tvec, e1)
        v = _dot(ds, qvec) * inv_det
        t = _dot(e2, qvec) * inv_det
        geo = act & (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
        ok = geo & _alpha_pass(bvh, ti, u, v) if alpha_test else geo
        new_hit = hit | ok.any(dim=1)

        # a TLAS leaf: enter the instance's BLAS in its object space
        enter = active & ~in_blas & is_leaf & box_hit
        inst = torch.clamp(leaf >> 4, 0, n_inst - 1)
        row = bvh.inst_row[torch.where(enter, inst, 0).long()]
        scale = row[:, 3:4]
        safe_s = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
        o_in = _rotate_conj(origin - row[:, 0:3], row[:, 4:8]) / safe_s
        d_in = _rotate_conj(direction, row[:, 4:8]) / safe_s

        local_next = torch.where(box_hit & ~is_leaf, ptr + 1, skip)
        blas_exit = in_blas & (local_next >= ncount)
        nxt_ptr = torch.where(enter, 0, torch.where(in_blas & blas_exit, resume, local_next))
        nxt_in_blas = torch.where(in_blas, ~blas_exit, enter)

        if counters:
            # the kernel stops a leaf at its first hit
            tested = act & ((torch.cumsum(ok.to(torch.int32), dim=1) - ok.to(torch.int32)) == 0)
            masked = tested & geo if alpha_test else torch.zeros_like(tested)
            count_of["nodes"] += active.to(torch.int32)
            count_of["tris"] += tested.sum(dim=1, dtype=torch.int32)
            count_of["instances"] += enter.to(torch.int32)
            count_of["masks"] += masked.sum(dim=1, dtype=torch.int32)
            count_of["node_rows"][gidx[active]] = True
            count_of["tri_rows"][ti[tested]] = True
            count_of["inst_rows"][inst[enter].long()] = True
            count_of["mask_rows"][torch.clamp(ti[masked], max=bvh.tri_alpha.shape[0] - 1)] = True

        def keep(new, old):
            return torch.where(frozen.view(-1, *([1] * (old.dim() - 1))), old, new)

        ptr = keep(nxt_ptr, ptr)
        in_blas = keep(nxt_in_blas, in_blas)
        base = keep(torch.where(enter, row[:, 8].to(torch.int32), base), base)
        ncount = keep(torch.where(enter, row[:, 9].to(torch.int32), ncount), ncount)
        tbase = keep(torch.where(enter, row[:, 10].to(torch.int32), tbase), tbase)
        resume = keep(torch.where(enter, skip, resume), resume)
        o_obj = keep(torch.where(enter[:, None], o_in, o_obj), o_obj)
        d_obj = keep(torch.where(enter[:, None], d_in, d_obj), d_obj)
        hit = new_hit
        steps += active.to(torch.int32)
    live = ~hit & ~(~in_blas & (ptr >= tlas_count))
    steps = torch.where(live, -1, steps)
    return (hit, steps, count_of) if counters else (hit, steps)


def _check_order(order, origin) -> None:
    """Raise ValueError unless order is an int32 [N] tensor on the rays'
    device holding each ray id once: the kernel walks ray order[s] for
    each slot s, so a repeated or missing id would leave a ray unwalked.
    The permutation is checked once per tensor and version (a sort and one
    read back), so shadow_pass's cached ray_order costs it once."""
    n = origin.shape[0] if origin.dim() else 0
    if (not isinstance(order, torch.Tensor) or order.dtype != torch.int32 or tuple(order.shape) != (n,)
            or order.device != origin.device):
        what = (f"{order.dtype} {tuple(order.shape)} on {order.device}" if isinstance(order, torch.Tensor)
                else type(order).__name__)
        raise ValueError(f"trace_any_hit: order must be int32 [{n}] on {origin.device}, got {what}")
    if getattr(order, "_checked_permutation", None) != order._version:
        if not torch.equal(torch.sort(order).values, torch.arange(n, dtype=torch.int32, device=order.device)):
            raise ValueError(f"trace_any_hit: order must hold each ray id in [0, {n}) once")
        order._checked_permutation = order._version


# trace.cu's ray counter, 4 bytes a (device, stream), zeroed by each launch
_COUNTERS: dict[tuple, torch.Tensor] = {}


def trace_cuda(bvh: ShadowBVH, origin, direction, *, t_min: float = 1e-3, t_max: float = 1e30,
               max_steps: int = 1024, alpha_test: bool = False, order=None, blocks: int = 0):
    """csrc/trace.cu's trace_any_hit<alpha_test>: trace_plain's contract,
    (occluded bool [N], steps int32 [N]).  Persistent warps take the rays
    in `order` (int32 [N], a permutation of the rays, else ValueError;
    None: id order) from a counter, in `blocks` blocks (0: as many as fill
    the card once); no schedule changes a result."""
    if order is not None:
        _check_order(order, origin)
    _build.require_cuda(origin, "trace_any_hit")
    for what, t in (("origin", origin), ("direction", direction)):
        _build.expect(t, torch.float32, (3,), f"trace_any_hit {what}")
    if origin.shape != direction.shape or origin.dim() != 2:
        raise ValueError(f"trace_any_hit: origin {tuple(origin.shape)} and direction {tuple(direction.shape)}")
    for f in TENSOR_FIELDS:
        t = getattr(bvh, f)
        if t.device != origin.device or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"trace_any_hit: bvh.{f} is {t.dtype} {tuple(t.shape)} on {t.device}, the rays on "
                             f"{origin.device}")
    widths = dict(nodes=8, inst_row=12, tri_uv=8, tri_alpha=8, tri_v0=3, tri_e1=3, tri_e2=3)
    if any(getattr(bvh, f).shape[1] != w for f, w in widths.items()) or len(bvh.tri_uv) != len(bvh.tri_alpha):
        raise ValueError(f"trace_any_hit: bvh shapes {[tuple(getattr(bvh, f).shape) for f in TENSOR_FIELDS]}")
    n = origin.shape[0]
    occluded = torch.zeros(n, dtype=torch.bool, device=origin.device)
    steps = torch.zeros(n, dtype=torch.int32, device=origin.device)
    nodes, inst = bvh.nodes.contiguous(), bvh.inst_row.contiguous()
    if n == 0 or nodes.shape[0] <= bvh.tlas_base or bvh.tri_v0.shape[0] == 0:
        return occluded, steps
    # one 48-byte row per triangle: v0 | e1 | e2 | pad
    tris = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, torch.zeros_like(bvh.tri_v0)], dim=1).contiguous()
    uv, alpha = bvh.tri_uv.contiguous(), bvh.tri_alpha.contiguous()
    origin, direction = origin.contiguous(), direction.contiguous()
    stream = _build.stream_ptr(origin)
    counter = _COUNTERS.get((origin.device, stream))
    if counter is None:
        counter = _COUNTERS[(origin.device, stream)] = torch.empty(1, dtype=torch.int32, device=origin.device)
    rc = _build.lib().trace_launch(
        nodes.data_ptr(), nodes.shape[0], bvh.tlas_base, tris.data_ptr(), tris.shape[0], inst.data_ptr(),
        inst.shape[0], uv.data_ptr(), alpha.data_ptr(), alpha.shape[0], origin.data_ptr(), direction.data_ptr(),
        None if order is None else order.contiguous().data_ptr(), n, t_min, t_max, max_steps, int(alpha_test),
        blocks, counter.data_ptr(), occluded.data_ptr(), steps.data_ptr(), stream)
    name = "trace_alpha" if alpha_test else "trace"
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)
    return occluded, steps


def trace_any_hit(bvh: ShadowBVH, origin, direction, *, t_min: float = 1e-3, t_max: float = 1e30,
                  max_steps: int = 1024, alpha_test: bool = False, order=None):
    """Two-level any-hit occlusion of rays origin/direction [N, 3] (world
    space) against `bvh` on their device, within max_steps node visits a
    ray: occluded bool [N].  alpha_test is the reference's quality-1 path:
    hits on masked triangles count only on an opaque cell.  CUDA tensors
    run trace.cu's kernel (trace_cuda, which takes the rays in `order`, a
    permutation such as ray_order's), CPU tensors trace_plain (whose
    result no order changes); both also give each ray's step count."""
    return _walk(bvh, origin, direction, t_min=t_min, t_max=t_max, max_steps=max_steps, alpha_test=alpha_test,
                 order=order)[0]


def _walk(bvh: ShadowBVH, origin, direction, *, order=None, **kw):
    """(occluded, steps) of trace_any_hit's walk: trace_plain on CPU
    tensors, trace_cuda (taking the rays in `order`) on CUDA ones."""
    if origin.device.type == "cpu":
        return trace_plain(bvh, origin, direction, **kw)
    return trace_cuda(bvh, origin, direction, order=order, **kw)


# ------------------------------------------------------------ filters and the pass


def checkerboard_fill(shadow, d_small, parity: int = 0):
    """Depth-similarity checkerboard reconstruction (shadow.py:511-536,
    the reference's shadowfill.comp.glsl:25-45): the untraced half of the
    pixels from their 4 neighbours (wrapping at the edges, as jnp.roll),
    weighted by exp2(-|d_n / d - 1| * 20)."""
    sh, sw = shadow.shape
    safe_d = torch.where(torch.abs(d_small) < 1e-20, 1e-20, d_small)
    num = den = None
    for shift, dim in ((1, 1), (-1, 1), (1, 0), (-1, 0)):
        wgt = torch.exp2(-torch.abs(torch.roll(d_small, shift, dim) / safe_d - 1.0) * 20.0)
        term = wgt * torch.roll(shadow, shift, dim)
        num, den = (term, wgt) if num is None else (num + term, den + wgt)
    filled = num / (den + 1e-2)
    rows = torch.arange(sh, device=shadow.device)[:, None]
    cols = torch.arange(sw, device=shadow.device)[None, :]
    return torch.where((rows + cols + parity) % 2 == 0, shadow, filled)


def shadow_blur(shadow, d_small, znear: float):
    """Depth-aware separable bilateral blur (shadow.py:542-564, the
    reference's shadowblur.comp.glsl:36-58): KERNEL taps per side, weight
    exp2(-i^2/50) x exp2(-|d_i - (d + dgrad*i)| * 100) on linear depth,
    dgrad predicted from the first neighbour when within 0.1.  Neighbours
    wrap around the image edges, as jnp.roll does."""
    lin = cullmath.rdiv(znear, torch.where(torch.abs(d_small) < 1e-20, 1e-20, d_small))
    for dim in (1, 0):  # horizontal, then vertical
        acc, accw = shadow, torch.ones_like(shadow)
        for sign in (-1, 1):
            dnext = torch.roll(lin, -sign, dim)
            dgrad = torch.where(torch.abs(lin - dnext) < 0.1, dnext - lin, 0.0)
            for i in range(1, SHADOW_BLUR_KERNEL + 1):
                sv = torch.roll(shadow, -sign * i, dim)
                dv = torch.roll(lin, -sign * i, dim)
                fw = float(np.exp2(-i * i / 50.0)) * torch.exp2(-torch.abs(dv - (lin + dgrad * i)) * 100.0)
                acc = acc + sv * fw
                accw = accw + fw
        shadow = acc / accw
    return shadow


def world_positions(depth, inverse_view_projection, width: int, height: int, scale: int):
    """(depth at 1/scale resolution [sh, sw], world positions [sh, sw, 3])
    of the pixel centers, from reverse-Z depth through the inverse
    view-projection (shadow.py:591-608): NDC planes by one IEEE division,
    the product written out term by term."""
    dev = depth.device
    sw, sh = width // scale, height // scale
    d_small = depth[::scale, ::scale][:sh, :sw]
    ndc_x = cullmath.div(torch.arange(sw, dtype=torch.float32, device=dev) + 0.5, sw)[None, :] * 2 - 1
    ndc_y = 1 - cullmath.div(torch.arange(sh, dtype=torch.float32, device=dev) + 0.5, sh)[:, None] * 2
    clip = (ndc_x.expand(sh, sw), ndc_y.expand(sh, sw), d_small)
    ivp = inverse_view_projection
    wposh = [clip[0] * float(ivp[i, 0]) + clip[1] * float(ivp[i, 1]) + clip[2] * float(ivp[i, 2])
             + float(ivp[i, 3]) for i in range(4)]
    wdiv = torch.where(torch.abs(wposh[3]) < 1e-20, 1e-20, wposh[3])
    return d_small, torch.stack(wposh[:3], dim=-1) / wdiv[..., None]


def ray_pixels(sh: int, sw: int, checkerboard: bool, parity: int, device):
    """(rows, cols) of shadow_pass's traced pixels on its [sh, sw] grid,
    ray i at (rows.flatten()[i], cols.flatten()[i]): with `checkerboard`
    the pixels of parity `parity` in each row, [sh, sw // 2]; else all."""
    r = torch.arange(sh, device=device)[:, None]
    if checkerboard:
        cols = torch.arange(sw // 2, device=device)[None, :] * 2 + (r + parity) % 2
    else:
        cols = torch.arange(sw, device=device)[None, :].expand(sh, sw)
    return r.expand_as(cols), cols


def _spread_bits(v):
    """The low 16 bits of v (int64) spread to the even bits."""
    for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        v = (v | (v << shift)) & mask
    return v


@functools.lru_cache(maxsize=None)
def ray_order(sh: int, sw: int, checkerboard: bool, parity: int, device):
    """The order in which csrc/trace.cu takes shadow_pass's rays: their
    pixels' Morton (Z-order) codes sorted, so the 32 rays a warp takes at
    once lie in one 8x8 pixel block of the [sh, sw] grid, not along one
    row.  int32 [rays], a permutation; built once per argument tuple."""
    rows, cols = ray_pixels(sh, sw, checkerboard, parity, device)
    code = _spread_bits(cols.reshape(-1).long()) | (_spread_bits(rows.reshape(-1).long()) << 1)
    return torch.argsort(code, stable=True).to(torch.int32)


def shadow_pass(depth, bvh: ShadowBVH, *, sun_direction, inverse_view_projection, width: int, height: int,
                scale: int = 2, checkerboard: bool = True, blur: bool = True, sun_jitter: float = 1e-2,
                znear: float = 0.1, parity: int = 0, quality: int = 0, capture: dict | None = None, stages=None):
    """Ray-traced shadow term [height, width] in [0, 1] (shadow.py:567-662,
    the reference's shadow.comp + shadowfill + shadowblur): rays from the
    world positions at 1/scale resolution toward the sun, its direction
    jittered per pixel by gradient noise when the blur can dissolve it;
    with `checkerboard` half the pixels traced (a checkerboard of parity
    `parity`) and the rest filled from their neighbours; 1 where nothing
    was drawn; blurred; repeated up to full size.  quality >= 1 traces
    with the alpha test.  `capture` receives the traced rays and their
    result ("trace": origin, direction, alpha_test, max_steps, occluded,
    and the kernel's ray order, None on the CPU).  Its
    spans (utils.profiling.span) are "rt rays+trace" and "rt fill+blur";
    `stages` (a StageTimer) gets their boundaries and the count "rt steps":
    the walk's steps, a ray cut at the budget counting max_steps, against
    its rays."""
    dev = depth.device
    sw, sh = width // scale, height // scale
    with span(stages, "rt rays+trace"):
        d_small, wpos = world_positions(depth, inverse_view_projection, width, height, scale)
        valid = d_small > 0.0

        jit = sun_jitter if blur else 0.0
        ys, xs = torch.meshgrid(torch.arange(sh, dtype=torch.float32, device=dev),
                                torch.arange(sw, dtype=torch.float32, device=dev), indexing="ij")
        n0 = cullmath.gradient_noise(torch.stack([xs, ys], dim=-1))
        n1 = cullmath.gradient_noise(torch.stack([ys, xs], dim=-1))
        sun = torch.as_tensor(np.asarray(sun_direction, np.float32), device=dev)
        dx = sun[0] + (n0 * 2 - 1) * jit
        dy = sun[1].expand(sh, sw)
        dz = sun[2] + (n1 * 2 - 1) * jit
        norm = torch.sqrt((dx * dx + dy * dy) + dz * dz)
        dirs = torch.stack([dx, dy, dz], dim=-1) / norm[..., None]

        rows, cols = ray_pixels(sh, sw, checkerboard, parity, dev)
        if checkerboard:
            origin, direction = wpos[rows, cols].reshape(-1, 3), dirs[rows, cols].reshape(-1, 3)
        else:
            origin, direction = wpos.reshape(-1, 3), dirs.reshape(-1, 3)
        max_steps = 1024
        order = ray_order(sh, sw, checkerboard, parity, dev) if dev.type == "cuda" else None
        occ, steps = _walk(bvh, origin, direction, max_steps=max_steps, alpha_test=quality >= 1, order=order)
        if capture is not None:
            capture["trace"] = dict(origin=origin, direction=direction, alpha_test=quality >= 1, max_steps=max_steps,
                                    occluded=occ, order=order)
        if stages is not None:  # a ray cut at the budget (-1) walked max_steps
            stages.count("rt steps", steps.remainder(max_steps + 1).sum(), steps.numel())
    with span(stages, "rt fill+blur"):
        if checkerboard:
            occluded = torch.zeros((sh, sw), dtype=torch.bool, device=dev)
            occluded[rows, cols] = occ.reshape(rows.shape)
        else:
            occluded = occ.reshape(sh, sw)

        shadow = torch.where(valid & occluded, 0.0, 1.0)
        if checkerboard:
            shadow = checkerboard_fill(shadow, d_small, parity)
        if blur:
            shadow = shadow_blur(shadow, d_small, znear)
        if scale > 1:
            shadow = shadow.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
    return shadow[:height, :width]
