"""Sun rays against every draw: does anything lie between a point and the
sun?  A brute-force test of each ray against every draw's bounding sphere,
then against every triangle of each draw the ray's line meets, in the
draw's own mesh space (Moller-Trumbore, any hit in front of the origin)."""

from __future__ import annotations

import torch


def sphere_pairs(origins, direction, centers, radii, chunk: int = 1 << 25):
    """(ray, draw) index pairs whose ray (origin [R, 3], unit `direction`
    [3], towards +infinity) meets the draw's sphere."""
    rs, ds = [], []
    step = max(1, chunk // max(len(centers), 1))
    for a in range(0, len(origins), step):
        o = origins[a:a + step]
        rel = centers[None, :, :] - o[:, None, :]
        t = rel @ direction
        d2 = (rel * rel).sum(-1) - t * t
        hit = (t > -radii[None, :]) & (d2 <= (radii * radii)[None, :])
        r, d = torch.nonzero(hit, as_tuple=True)
        rs.append(r + a)
        ds.append(d)
    return torch.cat(rs), torch.cat(ds)


def hit_distance(origins, direction, ray_idx, draw_idx, position, rotation, scale, verts, faces, eps: float = 1e-6,
                 chunk: int = 1 << 23):
    """For each (ray, draw) pair, the distance along the ray to the nearest
    of the draw's triangles (mesh-space `verts` [n, 3], `faces` [m, 3]) hit
    at t > 0, inf where none is: f32 [P].  The draw maps mesh space to the
    world by position + scale * rotation @ v; `direction` is a unit
    vector."""
    v0 = verts[faces[:, 0]]
    e1, e2 = verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0
    v0, e1, e2 = ([c[None, :] for c in a.unbind(1)] for a in (v0, e1, e2))
    out = torch.full((len(ray_idx),), torch.inf, dtype=torch.float32, device=origins.device)
    step = max(1, chunk // len(faces))
    for a in range(0, len(ray_idx), step):
        r, d = ray_idx[a:a + step], draw_idx[a:a + step]
        rt = rotation[d].transpose(1, 2)  # world -> mesh: R^T (x - p) / s
        o = (rt @ (origins[r] - position[d])[..., None])[..., 0] / scale[d, None]
        dr = (rt @ direction.expand(len(d), 3)[..., None])[..., 0] / scale[d, None]
        (ox, oy, oz), (dx, dy, dz) = ([c[:, None] for c in a.unbind(1)] for a in (o, dr))
        px, py, pz = dy * e2[2] - dz * e2[1], dz * e2[0] - dx * e2[2], dx * e2[1] - dy * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        ok = det.abs() >= 1e-12
        inv = 1.0 / torch.where(ok, det, 1.0)
        sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
        u = (sx * px + sy * py + sz * pz) * inv
        qx, qy, qz = sy * e1[2] - sz * e1[1], sz * e1[0] - sx * e1[2], sx * e1[1] - sy * e1[0]
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
        hit = ok & (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t > 0)
        out[a:a + step] = torch.where(hit, t, torch.inf).amin(dim=1).float()
    return out


def blocked(origins, direction, position, rotation, scale, radius: float, verts, faces, draw_mask=None):
    """bool [R]: whether any draw (where `draw_mask` is true) blocks each
    ray."""
    idx = torch.arange(len(position), device=position.device)
    if draw_mask is not None:
        idx = idx[draw_mask]
    r, d = sphere_pairs(origins, direction, position[idx], radius * scale[idx])
    d = idx[d]
    hit = torch.isfinite(hit_distance(origins, direction, r, d, position, rotation, scale, verts, faces))
    out = torch.zeros(len(origins), dtype=torch.bool, device=origins.device)
    out[r[hit]] = True
    return out


def first_hit(origins, direction, position, rotation, scale, radius: float, verts, faces, draw_mask, skip):
    """(distance, draw) of the nearest draw (where `draw_mask` is true, the
    ray's own draw `skip` [R] left out) along each ray: inf and -1 where
    none is hit."""
    idx = torch.nonzero(draw_mask).squeeze(1)
    r, d = sphere_pairs(origins, direction, position[idx], radius * scale[idx])
    d = idx[d]
    keep = d != skip[r]
    r, d = r[keep], d[keep]
    t = hit_distance(origins, direction, r, d, position, rotation, scale, verts, faces)
    best = torch.full((len(origins),), torch.inf, dtype=torch.float32, device=origins.device)
    t = t.float()
    best.scatter_reduce_(0, r, t, reduce="amin")
    win = torch.isfinite(t) & (t == best[r])
    draw = torch.full((len(origins),), -1, dtype=torch.int64, device=origins.device)
    draw[r[win]] = d[win]
    return best, draw
