"""Cluster ordering, per-cluster setup metadata and the sun map's setup
(niagara_tpu/ops/raster.py).

`order_clusters_by_x` (:190) sorts surviving clusters by projected screen
x; `transform_meta_direct` (:242) gathers what the setup kernel reads per
cluster; `compact_setup` (:262) is the XLA setup + compaction of corners
already in pixel space, which the sun map runs.  Keys are the reference's
u32 values held in int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import compact, cullmath
from .setup import REC

INVALID_FRAG = 0x7FFFFFFF  # vis value of a pixel no fragment covers


@dataclass
class Framebuffer:
    depth: torch.Tensor  # f32 [H,W], reverse-Z (0 = clear)
    vis: torch.Tensor  # i32 [H,W], fragment id or INVALID_FRAG


def order_clusters_by_x(scene, params, cluster_draw, cluster_mi, cluster_count):
    """Reorder clusters by projected screen-x center; dead tail slots sort
    after every live one.  Fragment ids follow this order, so it matches
    the reference's key (xq << slot_bits | slot) exactly."""
    K = cluster_draw.shape[0]
    dev = cluster_draw.device
    slot_bits = max(K - 1, 1).bit_length()
    xq_bits = 31 - slot_bits
    k = torch.arange(K, device=dev)
    live = k < cluster_count

    xf = scene.draw_xform_row[cluster_draw]
    mrow = scene.meshlet_cull_row[torch.clamp(cluster_mi, 0, scene.meshlet_cull_row.shape[0] - 1)]
    world = cullmath.rotate_quat(mrow[:, 0:3], xf[:, 4:8]) * xf[:, 3:4] + xf[:, 0:3]
    v = params.view
    camx = world[:, 0] * float(v[0, 0]) + world[:, 1] * float(v[0, 1]) + world[:, 2] * float(v[0, 2]) + float(v[0, 3])
    viewz = world[:, 0] * float(v[2, 0]) + world[:, 1] * float(v[2, 1]) + world[:, 2] * float(v[2, 2]) + float(v[2, 3])
    ratio = camx / torch.clamp_min(viewz, 1e-3)
    half = float(1 << (xq_bits - 1))
    xq = torch.clamp(ratio * 256.0 + half, 0.0, 2.0 * half - 1.0).to(torch.int64)
    key = torch.where(live, (xq << slot_bits) | k, (1 << 31) | k)
    idx = torch.sort(key).values & ((1 << slot_bits) - 1)
    return cluster_draw[idx], cluster_mi[idx]


def transform_meta_direct(scene, cluster_draw, cluster_mi, cluster_count):
    """Per-cluster setup inputs: meshlet index, triangle count, transform
    row and ids (the reference's dict minus the TPU row-table handles),
    plus the scene's opacity-mask table under "alpha" when it has masks
    (raster.py:257-258), which selects the setup kernel's alpha variant."""
    mi = torch.clamp(cluster_mi, 0, scene.meshlet_tris.shape[0] - 1)
    out = dict(
        mi=mi,
        tri_count=scene.meshlet_triangle_count[mi],
        xform=scene.draw_xform_row[cluster_draw],
        draw_id=cluster_draw,
        mat_index=scene.draw_material_index[cluster_draw],
        post_pass=scene.draw_post_pass[cluster_draw],
        count=torch.reshape(cluster_count, (1,)),
    )
    if scene.has_alpha_masks:
        out["alpha"] = scene.meshlet_alpha
    return out


def compact_setup(tc: dict, width: int, height: int, znear: float, capacity: int) -> dict:
    """Setup + ordered compaction of the [K, 96] triangles of `tc`, whose
    64 corners per cluster are already homogeneous pixel coordinates
    (hx, hy, viewz = w, zw) -- raster.py:262-504, op for op, in plain torch.
    The corners are fetched by a direct gather (the reference's bf16
    one-hot split is exact for them).  Where it differs from setup_plain,
    it follows the reference: the opacity-mask row (cols 48-55) is copied
    for every cluster when `tc` holds "alpha" (the scene's mask table,
    read at each cluster's `mi`), whatever its post class
    (raster.py:465-472); a non-finite depth plane zeroes only the plane
    (:387-392), no other column; cols 46-47 are zero.  Like the sun map's
    corners (sunmap.transform_sun), `tc` carries post classes, uvs only
    with masks, and no normals or materials: those columns are zero.

    The validity tests run over every slot; the records are built for the
    survivors only.  Returns setup_plain's dict: rec [capacity, REC]
    (col 13 = the compacted index, rows past `count` zero), x0/y0/x1/y1,
    tri_k/tri_t, valid, count, dropped."""
    tri = tc["tri"].to(torch.int64)
    K, T = tri.shape[:2]
    dev = tri.device
    W, H = float(width), float(height)

    def corner_of(key, li):
        return tc[key].gather(1, li)

    corners = []
    for c in range(3):
        li = tri[..., c]
        corners.append(dict(hx=corner_of("hx", li), hy=corner_of("hy", li), w=corner_of("viewz", li),
                            zw=corner_of("zw", li)))
    A, B, C = corners

    def cross_rows(p, r):
        return (p["w"] * r["hy"] - p["hy"] * r["w"],
                p["hx"] * r["w"] - p["w"] * r["hx"],
                p["hy"] * r["hx"] - p["hx"] * r["hy"])

    eAB, eBC, eCA = cross_rows(A, B), cross_rows(B, C), cross_rows(C, A)
    det = A["hx"] * eBC[0] + A["hy"] * eBC[1] + A["w"] * eBC[2]
    front = det > 0.0
    inv_det = torch.where(torch.abs(det) < 1e-30, 0.0, cullmath.rdiv(1.0, det))
    ka, kb, kc = A["zw"] * A["w"], B["zw"] * B["w"], C["zw"] * C["w"]
    za = (ka * eBC[0] + kb * eCA[0] + kc * eAB[0]) * inv_det
    zb = (ka * eBC[1] + kb * eCA[1] + kc * eAB[1]) * inv_det
    zc = (ka * eBC[2] + kb * eCA[2] + kc * eAB[2]) * inv_det

    # post classes: double-sided (back faces flip edge signs) + depth bias
    post = tc["post_pass"]
    is_post = (post > 0)[:, None].expand(K, T)
    flip = is_post & (det < 0.0)
    sgn = torch.where(flip, -1.0, 1.0)
    eAB, eBC, eCA = (tuple(e * sgn for e in es) for es in (eAB, eBC, eCA))
    zbias = torch.where(is_post, 1.0 + 2.0**-19, 1.0)
    za, zb, zc = za * zbias, zb * zbias, zc * zbias
    front = front | flip

    zfin = torch.maximum(torch.maximum(torch.abs(za), torch.abs(zb)), torch.abs(zc)) < 1e30
    za, zb, zc = (torch.where(zfin, z, 0.0) for z in (za, zb, zc))
    front = front & zfin

    def sdiv(h, w):
        return h / torch.where(w > 1e-9, w, 1e-9)

    sx = [sdiv(c["hx"], c["w"]) for c in corners]
    sy = [sdiv(c["hy"], c["w"]) for c in corners]
    behind_any = (A["w"] <= 1e-9) | (B["w"] <= 1e-9) | (C["w"] <= 1e-9)
    all_behind = (A["w"] < znear) & (B["w"] < znear) & (C["w"] < znear)
    x0f = torch.where(behind_any, 0.0, torch.floor(torch.minimum(torch.minimum(sx[0], sx[1]), sx[2])))
    y0f = torch.where(behind_any, 0.0, torch.floor(torch.minimum(torch.minimum(sy[0], sy[1]), sy[2])))
    x1f = torch.where(behind_any, W, torch.ceil(torch.maximum(torch.maximum(sx[0], sx[1]), sx[2])))
    y1f = torch.where(behind_any, H, torch.ceil(torch.maximum(torch.maximum(sy[0], sy[1]), sy[2])))
    on_screen = (x1f > 0) & (y1f > 0) & (x0f < W) & (y0f < H)
    x0d, y0d = torch.clamp(x0f, 0.0, W - 1.0), torch.clamp(y0f, 0.0, H - 1.0)
    x1d, y1d = torch.clamp(x1f, 0.0, W), torch.clamp(y1f, 0.0, H)
    valid = tc["tri_valid"] & front & ~all_behind & on_screen & (x1d > x0d) & (y1d > y0d)

    tidx, count, dropped = compact.compact_mask_indices(valid.reshape(-1), capacity)
    live = torch.arange(capacity, device=dev) < count
    k, t = tidx // T, tidx % T

    def pick(a):  # a dense [K, T] column at the survivors
        return a.reshape(-1)[tidx]

    cols = [pick(a) for a in (*eAB, *eBC, *eCA, za, zb, zc, x0d, y0d, x1d, y1d)]
    zero = torch.zeros_like(cols[0])
    uv = tc.get("uv")
    for c in range(3):
        li = tri[k, t, c]
        cols += [pick(sx[c]), pick(sy[c]), pick(corners[c]["w"]), zero, zero, zero]  # no normals
        cols += [uv[k, li, 0], uv[k, li, 1]] if uv is not None else [zero, zero]
    cols += [tc["vid"][k, tri[k, t, c]].to(torch.float32) for c in range(3)]
    cols += [tc["draw_id"][k].to(torch.float32), zero, post[k].to(torch.float32), zero, zero]  # no material
    if "alpha" in tc:  # the scene's mask table, by meshlet
        m = tc["mi"][k]
        cols += [tc["alpha"][m, i, t] for i in range(8)]
    rec = torch.zeros((capacity, REC), dtype=torch.float32, device=dev)
    rec[:, : len(cols)] = torch.where(live[:, None], torch.stack(cols, dim=-1), 0.0)
    aabb = rec[:, 12:16].T.to(torch.int32).contiguous()  # x0 y0 x1 y1 before col 13 takes the index
    rec[:, 13] = torch.where(live, torch.arange(capacity, device=dev).to(torch.float32), 0.0)
    tidx = torch.where(live, tidx, 0)
    return dict(rec=rec, x0=aabb[0], y0=aabb[1], x1=aabb[2], y1=aabb[3], tri_k=tidx // T, tri_t=tidx % T,
                valid=live, count=count, dropped=dropped)
