"""Triangle transform + setup + ordered compaction.

Port of niagara_tpu/ops/setup_fused.py::setup_compact (:676), whose Pallas
kernel `_setup_kernel` (:190) becomes csrc/setup.cu, in both its variants:
no-alpha, and alpha (`_setup_kernel_alpha` :166), chosen statically when
`tc` carries the scene's opacity-mask table (`tc["alpha"]`, a scene with
masks; setup_fused.py:714).
`setup_plain` is the same function in plain torch: the corner transform of
setup_fused.py:297-356 followed by the setup and compaction math of
raster.compact_setup (raster.py:331-504), op for op in the kernel's order.

Record layout (REC = 56 f32 per triangle, as the reference):
  0-8 edge equations eAB eBC eCA, 9-11 depth plane, 12-15 x0 y0 x1 y1
  (col 13 overwritten with the record's compacted index), 16-39 per corner
  A/B/C: screen x, y, viewz, world normal xyz, u, v; 40-42 vertex ids;
  43 draw, 44 material, 45 post class; 46 flat cluster*96+tri index;
  47 zero; 48-55 zero, or in the alpha variant the triangle's opacity-mask
  row (4 mask halves, u0, v0, 8/du, 8/dv) for clusters of post class > 0
  and exactly 0 for the rest (select, not multiply: setup_fused.py:455-463).

Corners are read from f32 `meshlet_vdata`.  The TPU kernel reads them
through a 2-way bf16 split (scene.py:438-448), exact for the fp16
positions and uvs but keeping ~16 mantissa bits of the snorm-decoded
normals, so normal-derived columns differ from the reference at ~2^-16.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import MESH_MAXTRI, MESH_MAXVTX

from .. import _build
from . import compact, cullmath

REC = 56
SETUP_THREADS = 256  # triangle slots per block in csrc/setup.cu


def setup_compact(tc: dict, scene, params, width: int, height: int, capacity: int) -> dict:
    """Setup + compaction of the [K, 96] triangle slots of `tc`
    (raster.transform_meta_direct; the alpha variant when it holds
    "alpha").  Returns rec [capacity, REC] f32,
    x0/y0/x1/y1 [capacity] i32, tri_k/tri_t [capacity] int64, valid,
    count and dropped (0-d int64).  Rows past `count` are zero."""
    if tc["mi"].device.type == "cpu":
        return setup_plain(tc, scene, params, width, height, capacity)
    return setup_cuda(tc, scene, params, width, height, capacity)


def _view_consts(params, width, height):
    v = params.view
    return [float(v[i, j]) for i in range(3) for j in range(4)] + [
        float(params.p00), float(params.p11), float(params.znear), float(width), float(height)]


def setup_cuda(tc, scene, params, width, height, capacity):
    """The setup kernel (csrc/setup.cu), its alpha variant when `tc` holds
    "alpha": setup_plain's contract."""
    mi = tc["mi"]
    alpha = tc.get("alpha")
    name = "setup" if alpha is None else "setup_alpha"
    _build.require_cuda(mi, name)
    _build.expect(tc["xform"], torch.float32, (mi.shape[0], 8), "setup xform")
    _build.expect(scene.meshlet_tris, torch.int32, (MESH_MAXTRI, 3), "meshlet_tris")
    _build.expect(scene.meshlet_vdata, torch.float32, (MESH_MAXVTX, 8), "meshlet_vdata")
    _build.expect(scene.meshlet_vertices, torch.int32, (MESH_MAXVTX,), "meshlet_vertices")
    if alpha is not None:
        _build.expect(alpha, torch.float32, (scene.meshlet_tris.shape[0], 8, 2 * MESH_MAXVTX), "meshlet_alpha")
        alpha = alpha.contiguous()
    dev = mi.device
    K = mi.shape[0]
    lib = _build.lib()
    i32 = lambda t: t.to(torch.int32).contiguous()
    c = _view_consts(params, width, height)
    prm = _build.SetupParams((ctypes.c_float * 12)(*c[:12]), *c[12:])
    n_blocks = -(-K * MESH_MAXTRI // SETUP_THREADS)
    block_counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    block_offsets = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    rec = torch.zeros((capacity, REC), dtype=torch.float32, device=dev)
    aabb = torch.zeros((4, capacity), dtype=torch.int32, device=dev)
    flat = torch.zeros(capacity, dtype=torch.int32, device=dev)
    count_in = tc["count"].to(torch.int64).contiguous()
    args = [i32(mi), i32(tc["tri_count"]), tc["xform"].contiguous(), i32(tc["draw_id"]),
            i32(tc["mat_index"]), i32(tc["post_pass"])]
    scene_args = [scene.meshlet_tris.contiguous(), scene.meshlet_vdata.contiguous(),
                  scene.meshlet_vertices.contiguous()]
    rc = lib.setup_launch(
        count_in.data_ptr(), *(a.data_ptr() for a in args), K,
        *(a.data_ptr() for a in scene_args), None if alpha is None else alpha.data_ptr(), prm, capacity,
        block_counts.data_ptr(), block_offsets.data_ptr(), total.data_ptr(),
        rec.data_ptr(), aabb.data_ptr(), flat.data_ptr(), _build.stream_ptr(mi),
    )
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)
    raw = total[0].to(torch.int64)
    count = torch.clamp_max(raw, capacity)
    flat = flat.to(torch.int64)
    return dict(
        rec=rec, x0=aabb[0], y0=aabb[1], x1=aabb[2], y1=aabb[3],
        tri_k=flat // MESH_MAXTRI, tri_t=flat % MESH_MAXTRI,
        valid=torch.arange(capacity, device=dev) < count,
        count=count, dropped=torch.clamp_min(raw - capacity, 0),
    )


def _rot_quat(q, px, py, pz):
    """tmp = cross(q.xyz, p) + q.w*p; p + 2*cross(q.xyz, tmp) (setup_fused.py:314)."""
    qx, qy, qz, qw = q
    txq = qy * pz - qz * py + qw * px
    tyq = qz * px - qx * pz + qw * py
    tzq = qx * py - qy * px + qw * pz
    return (px + 2.0 * (qy * tzq - qz * tyq),
            py + 2.0 * (qz * txq - qx * tzq),
            pz + 2.0 * (qx * tyq - qy * txq))


def setup_plain(tc: dict, scene, params, width: int, height: int, capacity: int) -> dict:
    """Plain torch setup_compact: every [K, 96] slot evaluated densely."""
    mi = tc["mi"]
    dev = mi.device
    K = mi.shape[0]
    v00, v01, v02, v03, v10, v11, v12, v13, v20, v21, v22, v23, p00, p11, znear, W, H = \
        _view_consts(params, width, height)
    xf = tc["xform"][:, None, :]  # [K,1,8]
    tx, ty, tz, sc = xf[..., 0], xf[..., 1], xf[..., 2], xf[..., 3]
    q = (xf[..., 4], xf[..., 5], xf[..., 6], xf[..., 7])
    tris = scene.meshlet_tris[mi]  # [K,96,3]
    rows = mi[:, None].expand(K, MESH_MAXTRI)

    corners = []
    for c in range(3):
        li = tris[..., c]
        vd = scene.meshlet_vdata[rows, li]  # [K,96,8]
        wx, wy, wz = _rot_quat(q, vd[..., 0], vd[..., 1], vd[..., 2])
        wx, wy, wz = wx * sc + tx, wy * sc + ty, wz * sc + tz
        camx = v00 * wx + v01 * wy + v02 * wz + v03
        camy = v10 * wx + v11 * wy + v12 * wz + v13
        viewz = v20 * wx + v21 * wy + v22 * wz + v23
        safe_z = torch.where(torch.abs(viewz) < 1e-12, 1e-12, viewz)
        zw = cullmath.rdiv(znear, safe_z)
        hx = (p00 * camx * 0.5 + 0.5 * viewz) * W
        hy = (0.5 * viewz - p11 * camy * 0.5) * H
        # 1/256 subpixel snap, round half to even like jnp.round
        wpos = viewz > 1e-9
        hx = torch.where(wpos, torch.round(hx / safe_z * 256.0) * (1.0 / 256.0) * viewz, hx)
        hy = torch.where(wpos, torch.round(hy / safe_z * 256.0) * (1.0 / 256.0) * viewz, hy)
        n = _rot_quat(q, vd[..., 3], vd[..., 4], vd[..., 5])
        vid = scene.meshlet_vertices[rows, li].to(torch.float32)
        corners.append(dict(hx=hx, hy=hy, w=viewz, zw=zw, n=n, u=vd[..., 6], v=vd[..., 7], vid=vid))
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
    is_post = (tc["post_pass"] > 0)[:, None].expand(K, MESH_MAXTRI)
    flip = is_post & (det < 0.0)
    sgn = torch.where(flip, -1.0, 1.0)
    eAB, eBC, eCA = (tuple(e * sgn for e in es) for es in (eAB, eBC, eCA))
    zbias = torch.where(is_post, 1.0 + 2.0**-19, 1.0)
    za, zb, zc = za * zbias, zb * zbias, zc * zbias
    front = front | flip

    # non-finite depth planes (slivers) are invalid and zeroed
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

    t_idx = torch.arange(MESH_MAXTRI, device=dev)[None, :]
    k_idx = torch.arange(K, device=dev)[:, None]
    tri_live = (t_idx < tc["tri_count"][:, None]) & (k_idx < tc["count"])
    x0d, y0d = torch.clamp(x0f, 0.0, W - 1.0), torch.clamp(y0f, 0.0, H - 1.0)
    x1d, y1d = torch.clamp(x1f, 0.0, W), torch.clamp(y1f, 0.0, H)
    valid = tri_live & front & ~all_behind & on_screen & (x1d > x0d) & (y1d > y0d)

    flat = (k_idx * MESH_MAXTRI + t_idx).to(torch.float32).expand(K, MESH_MAXTRI)

    def per_cluster(a):
        return a.to(torch.float32)[:, None].expand(K, MESH_MAXTRI)

    cols = [*eAB, *eBC, *eCA, za, zb, zc, x0d, y0d, x1d, y1d]
    for i, c in enumerate(corners):
        cols += [sx[i], sy[i], c["w"], *c["n"], c["u"], c["v"]]
    cols += [A["vid"], B["vid"], C["vid"], per_cluster(tc["draw_id"]), per_cluster(tc["mat_index"]),
             per_cluster(tc["post_pass"]), flat]
    if "alpha" in tc:  # mask rows of post clusters, exact zeros elsewhere
        cols.append(torch.zeros_like(flat))
        mask_rows = tc["alpha"][mi][:, :, :MESH_MAXTRI]  # [K, 8, 96]
        cols += [torch.where(is_post, mask_rows[:, i], 0.0) for i in range(8)]
    rec_all = torch.stack(cols, dim=-1).reshape(K * MESH_MAXTRI, len(cols))
    rec_all = torch.where(torch.isfinite(rec_all), rec_all, 0.0)

    tidx, count, dropped = compact.compact_mask_indices(valid.reshape(-1), capacity)
    live = torch.arange(capacity, device=dev) < count
    rec = torch.zeros((capacity, REC), dtype=torch.float32, device=dev)
    rec[:, : len(cols)] = torch.where(live[:, None], rec_all[tidx], 0.0)
    aabb = rec[:, 12:16].T.to(torch.int32).contiguous()  # x0 y0 x1 y1 before col 13 takes the index
    rec[:, 13] = torch.where(live, torch.arange(capacity, device=dev).to(torch.float32), 0.0)
    tidx = torch.where(live, tidx, 0)
    return dict(
        rec=rec, x0=aabb[0], y0=aabb[1], x1=aabb[2], y1=aabb[3],
        tri_k=tidx // MESH_MAXTRI, tri_t=tidx % MESH_MAXTRI,
        valid=live, count=count, dropped=dropped,
    )
