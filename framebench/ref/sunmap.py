"""The sun's depth map where moving draws were: for a texel of an
orthographic map seen from the sun, the nearest surface along the ray
through the texel's centre, by a brute-force ray test (rays.py).

A map frame is (rows, lo, hi): `rows` [3, 3] maps the world to the map's
basis (u and v across the map, the third along the sun's light, into the
scene), and [lo, hi] bounds the map in that basis.  Texel (x, y) of a
W x H map has its centre at u = lo_u + (x + 0.5) / W (hi_u - lo_u), and
likewise v; a surface at basis depth d is stored as the reverse depth
1 - 0.998 (d - lo_d) / (hi_d - lo_d), 0 where nothing is.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rays, shade

INSET = 0.03  # mesh units under a moving draw's surface, where its texels are aimed


def aimed_texels(position, rotation, scale, verts, normals, rows, lo, hi, map_w: int, map_h: int, count: int,
                 seed: int, points_per_draw: int = 8):
    """Up to `count` texels (y * W + x) drawn from `seed`, each through a
    point just under the surface of one of the draws (`position`,
    `rotation`, `scale` [n, ...]), so that its ray meets the draw's
    interior."""
    dev = position.device
    at = torch.linspace(0, len(verts) - 1, points_per_draw, device=dev).long()
    pick = verts[at] - INSET * normals[at]
    pts = position[:, None, :] + scale[:, None, None] * torch.einsum("dij,nj->dni", rotation, pick)
    sc = pts.reshape(-1, 3) @ rows.T
    x = torch.floor((sc[:, 0] - lo[0]) / (hi[0] - lo[0]) * map_w).long()
    y = torch.floor((sc[:, 1] - lo[1]) / (hi[1] - lo[1]) * map_h).long()
    ok = (x >= 0) & (x < map_w) & (y >= 0) & (y < map_h)
    tex = torch.unique(y[ok] * map_w + x[ok])
    g = torch.Generator().manual_seed(seed % (1 << 63))
    return torch.sort(tex[torch.randperm(len(tex), generator=g)[:count].to(dev)]).values


def depths(texels, rows, lo, hi, map_w: int, map_h: int, position, orientation, scale, radius: float, verts, faces,
           dtype=torch.float32, draw_mask=None):
    """(reverse depth [K], nearest draw [K], -1 where none) at the texels,
    over the draws where `draw_mask` is true (all by default), computed in
    `dtype` (the control's bfloat16)."""
    rows, lo, hi = rows.to(dtype), lo.to(dtype), hi.to(dtype)
    x = (texels % map_w).to(dtype)
    y = (texels // map_w).to(dtype)
    u = lo[0] + (x + 0.5) / map_w * (hi[0] - lo[0])
    v = lo[1] + (y + 0.5) / map_h * (hi[1] - lo[1])
    start = lo[2] - 1.0
    origins = u[:, None] * rows[0] + v[:, None] * rows[1] + start * rows[2]
    rot = shade.quat_matrix(orientation.to(dtype))
    everything = torch.ones(len(position), dtype=torch.bool, device=position.device) if draw_mask is None \
        else draw_mask
    none = torch.full((len(texels),), -1, dtype=torch.int64, device=position.device)
    t, hit = rays.first_hit(origins, rows[2], position.to(dtype), rot, scale.to(dtype), radius, verts.to(dtype),
                            faces, everything, none)
    d = (start + t.to(dtype) - lo[2]) / (hi[2] - lo[2])
    z = torch.where(hit >= 0, 1.0 - 0.998 * d, torch.zeros_like(d))
    return z.float(), hit


def frame_arrays(sf: dict, dev):
    return tuple(torch.as_tensor(np.asarray(sf[k].cpu() if torch.is_tensor(sf[k]) else sf[k]), dtype=torch.float32,
                                 device=dev) for k in ("rows", "lo", "hi"))


def fit_frame(sun, positions, margin: float = 8.0) -> dict:
    """A map frame over draws at `positions` [D, 3] (their box grown by
    `margin` for the meshes), seen along the light (-`sun`): u = up x
    light, v = light x u, with up the y axis (x where the light is near
    it)."""
    light = -np.asarray(sun, np.float64)
    light /= np.linalg.norm(light)
    up = np.array([1.0, 0.0, 0.0]) if abs(light[1]) > 0.99 else np.array([0.0, 1.0, 0.0])
    u = np.cross(up, light)
    u /= np.linalg.norm(u)
    rows = np.stack([u, np.cross(light, u), light])
    p = np.asarray(positions, np.float64)
    mn, mx = p.min(axis=0) - margin, p.max(axis=0) + margin
    corners = np.array([[a[0], b[1], c[2]] for a in (mn, mx) for b in (mn, mx) for c in (mn, mx)])
    sc = corners @ rows.T
    return dict(rows=torch.tensor(rows, dtype=torch.float32), lo=torch.tensor(sc.min(0) - 1e-3, dtype=torch.float32),
                hi=torch.tensor(sc.max(0) + 1e-3, dtype=torch.float32))
