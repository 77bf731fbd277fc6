"""A brute-force z-buffer: every triangle's screen box is expanded into its
pixels, each pixel centre inside the triangle is a fragment, and the
nearest fragment of every pixel wins.

Screen space: pixel (x, y) has its centre at (x + 0.5, y + 0.5), x to the
right and y down; a view-space point (vx, vy, w) with w > 0 in front of
the camera lands at ((p00 vx / w + 1) W / 2, (1 - p11 vy / w) H / 2).
Depth is the view distance w, interpolated perspective-correctly.  As the
renderer draws them, triangles are cut at the near plane w = znear
(`clip_near`), and single-sided ones are drawn only from the front
(`front_facing`).
"""

from __future__ import annotations

import torch

EMPTY = torch.iinfo(torch.int64).max


def project(view_pts: torch.Tensor, p00: float, p11: float, width: int, height: int):
    """(sx, sy, w) of view-space points [..., 3]."""
    w = view_pts[..., 2]
    sx = (p00 * view_pts[..., 0] / w + 1.0) * (0.5 * width)
    sy = (1.0 - p11 * view_pts[..., 1] / w) * (0.5 * height)
    return sx, sy, w


def front_facing(view_tris: torch.Tensor) -> torch.Tensor:
    """Whether each triangle of view-space corners (x, y, w) [T, 3, 3] faces
    the eye: its corners run counter-clockwise on the screen (y up), which
    for corners a, b, c is det[a; b; c] > 0, taken as ((b - a) x (c - a)) . a."""
    a, b, c = view_tris[:, 0], view_tris[:, 1], view_tris[:, 2]
    return (torch.linalg.cross(b - a, c - a) * a).sum(1) > 0


def clip_near(view_tris: torch.Tensor, znear: float):
    """Triangles of view-space corners (x, y, w) [T, 3, 3] cut at the near
    plane: those wholly at w >= znear kept in their order, those wholly
    nearer dropped, and each that crosses replaced, after them, by the one
    or two triangles of its part beyond the plane, in the same winding.
    Returns (corners [T', 3, 3], source triangle [T'], the number kept
    whole, weights [T' - kept, 3, 3]: a cut triangle's corner j is the sum
    over k of weights[j, k] times its source's corner k)."""
    dev = view_tris.device
    w = view_tris[..., 2]
    beyond = w >= znear
    n_in = beyond.sum(1)
    whole = torch.nonzero(n_in == 3).squeeze(1)
    eye = torch.eye(3, device=dev)

    def cut(x, y, tri):
        """Weights [n, 3] of the point where edge x -> y meets the plane."""
        wx, wy = w[tri, x], w[tri, y]
        t = ((znear - wx) / (wy - wx))[:, None]
        return eye[x] * (1.0 - t) + eye[y] * t

    src, weights = [whole], []
    one = torch.nonzero(n_in == 1).squeeze(1)  # a beyond: the triangle (a, a-b cut, c-a cut)
    if len(one):
        a = torch.argmax(beyond[one].to(torch.int8), 1)
        b, c = (a + 1) % 3, (a + 2) % 3
        src.append(one)
        weights.append(torch.stack([eye[a], cut(a, b, one), cut(a, c, one)], 1))
    two = torch.nonzero(n_in == 2).squeeze(1)  # c nearer: (a, b, b-c cut) and (a, b-c cut, c-a cut)
    if len(two):
        c = torch.argmin(beyond[two].to(torch.int8), 1)
        a, b = (c + 1) % 3, (c + 2) % 3
        bc, ca = cut(b, c, two), cut(a, c, two)
        src += [two, two]
        weights += [torch.stack([eye[a], eye[b], bc], 1), torch.stack([eye[a], bc, ca], 1)]
    src = torch.cat(src)
    weights = torch.cat(weights) if weights else torch.zeros((0, 3, 3), device=dev)
    cut_tris = weights @ view_tris[src[len(whole):]]
    cut_tris[..., 2] = torch.clamp_min(cut_tris[..., 2], znear)
    return torch.cat([view_tris[whole], cut_tris]), src, len(whole), weights


def barycentric(x, y, tx, ty):
    """Screen-space barycentrics of points (x, y) in triangles tx, ty [..., 3]
    and the triangles' doubled signed areas."""
    e0 = (tx[..., 2] - tx[..., 1]) * (y - ty[..., 1]) - (ty[..., 2] - ty[..., 1]) * (x - tx[..., 1])
    e1 = (tx[..., 0] - tx[..., 2]) * (y - ty[..., 2]) - (ty[..., 0] - ty[..., 2]) * (x - tx[..., 2])
    area = (tx[..., 1] - tx[..., 0]) * (ty[..., 2] - ty[..., 0]) - (ty[..., 1] - ty[..., 0]) * (tx[..., 2] - tx[..., 0])
    safe = torch.where(area == 0, 1.0, area)
    b0, b1 = e0 / safe, e1 / safe
    return b0, b1, 1.0 - b0 - b1, area


def zbuffer(tx, ty, tw, width: int, height: int, znear: float, keep=None, budget: int = 1 << 25):
    """The nearest fragment of every pixel over triangles with screen
    coordinates tx, ty and view distances tw [T, 3]: int64 keys [H * W],
    (float bits of w) << 32 | triangle index, EMPTY where nothing covers.
    A triangle with a vertex nearer than `znear` is skipped: `clip_near`
    cuts them first.  `keep(tri,
    b, inv_w)` (optional) says which fragments of which triangles survive
    an alpha test, given the perspective-correct barycentrics."""
    dev = tx.device
    zbuf = torch.full((height * width,), EMPTY, dtype=torch.int64, device=dev)
    ok = (tw >= znear).all(dim=1)
    x0 = torch.clamp(torch.ceil(tx.amin(1) - 0.5), 0, width - 1).to(torch.int64)
    x1 = torch.clamp(torch.floor(tx.amax(1) - 0.5), -1, width - 1).to(torch.int64)
    y0 = torch.clamp(torch.ceil(ty.amin(1) - 0.5), 0, height - 1).to(torch.int64)
    y1 = torch.clamp(torch.floor(ty.amax(1) - 0.5), -1, height - 1).to(torch.int64)
    bw, bh = x1 - x0 + 1, y1 - y0 + 1
    count = torch.where(ok & (bw > 0) & (bh > 0), bw * bh, 0)
    tris = torch.nonzero(count).squeeze(1)
    if tris.numel() == 0:
        return zbuf
    ends = torch.cumsum(count[tris], 0).cpu()
    # chunks of whole triangles with at most `budget` fragments each (a
    # triangle larger than the budget is a chunk of its own)
    bounds, start = [], 0
    while start < len(tris):
        base = int(ends[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(ends, base + budget, right=True)), start + 1)
        bounds.append((start, stop))
        start = stop
    for a, b in bounds:
        t = tris[a:b]
        n = count[t]
        tri = torch.repeat_interleave(t, n)
        first = torch.cumsum(n, 0) - n
        local = torch.arange(int(n.sum()), device=dev) - torch.repeat_interleave(first, n)
        px = x0[tri] + local % bw[tri]
        py = y0[tri] + local // bw[tri]
        b0, b1, b2, area = barycentric(px.to(tx.dtype) + 0.5, py.to(tx.dtype) + 0.5, tx[tri], ty[tri])
        inside = (area != 0) & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        w3 = tw[tri]
        inv_w = b0 / w3[:, 0] + b1 / w3[:, 1] + b2 / w3[:, 2]
        if keep is not None:
            inside &= keep(tri, (b0, b1, b2), inv_w)
        sel = torch.nonzero(inside).squeeze(1)
        w = (1.0 / inv_w[sel]).to(torch.float32)
        key = (w.view(torch.int32).to(torch.int64) << 32) | tri[sel]
        zbuf.scatter_reduce_(0, py[sel] * width + px[sel], key, reduce="amin")
    return zbuf


def decode(zbuf: torch.Tensor):
    """(triangle index [N] i64, -1 where empty; view distance [N] f32, inf
    where empty) of z-buffer keys."""
    empty = zbuf == EMPTY
    tri = torch.where(empty, -1, zbuf & 0xFFFFFFFF)
    w = (zbuf >> 32).to(torch.int32).view(torch.float32)
    return tri, torch.where(empty, torch.inf, w)
