"""Levels of detail of a surface given on a periodic (u, v) grid.

A level keeps every su-th vertex along u and every sv-th along v, so its
vertices lie on the surface and keep their normals and uvs.  Its error is
the largest distance between a full-resolution vertex and the point of the
coarse mesh at the same (u, v) (the two triangles of a cell split along
the cell's diagonal as the full grid's faces are): a bound on how far the
level departs from the surface, in mesh units.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Level:
    su: int
    sv: int
    error: float
    positions: np.ndarray  # f32 [n, 3]
    normals: np.ndarray  # f32 [n, 3]
    uvs: np.ndarray  # f32 [n, 2]
    faces: np.ndarray  # i64 [m, 3]


def grid_faces(nu: int, nv: int) -> np.ndarray:
    """Two triangles a cell of a periodic nu x nv grid (vertex iu * nv + iv):
    (p, p+u, p+u+v) and (p, p+u+v, p+v)."""
    idx = np.arange(nu * nv).reshape(nu, nv)
    nu_ = np.roll(idx, -1, axis=0)
    nv_, nuv = np.roll(idx, -1, axis=1), np.roll(nu_, -1, axis=1)
    return np.concatenate([np.stack([idx, nu_, nuv], -1).reshape(-1, 3),
                           np.stack([idx, nuv, nv_], -1).reshape(-1, 3)]).astype(np.int64)


def level_error(grid: np.ndarray, su: int, sv: int) -> float:
    """The level's error over the full grid [NU, NV, 3] (float64)."""
    NU, NV, _ = grid.shape
    iu, iv = np.arange(NU)[:, None], np.arange(NV)[None, :]
    a = (iu % su) / su + 0 * iv
    b = (iv % sv) / sv + 0 * iu
    u0, v0 = (iu // su) * su + 0 * iv, (iv // sv) * sv + 0 * iu
    u1, v1 = (u0 + su) % NU, (v0 + sv) % NV
    p00, p10, p01, p11 = grid[u0, v0], grid[u1, v0], grid[u0, v1], grid[u1, v1]
    a3, b3 = a[..., None], b[..., None]
    lower = p00 + a3 * (p10 - p00) + b3 * (p11 - p10)  # a >= b: (p00, p10, p11)
    upper = p00 + a3 * (p11 - p01) + b3 * (p01 - p00)  # b > a: (p00, p11, p01)
    interp = np.where((a >= b)[..., None], lower, upper)
    return float(np.sqrt(((grid - interp) ** 2).sum(-1)).max())


def build_levels(positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, nu: int, nv: int,
                 min_u: int = 4, min_v: int = 3) -> list[Level]:
    """Every level whose steps divide the grid and leave at least
    min_u x min_v vertices, finest first by triangle count."""
    grid = positions.astype(np.float64).reshape(nu, nv, 3)
    levels = []
    for su in [s for s in range(1, nu + 1) if nu % s == 0 and nu // s >= min_u]:
        for sv in [s for s in range(1, nv + 1) if nv % s == 0 and nv // s >= min_v]:
            keep = (np.arange(0, nu, su)[:, None] * nv + np.arange(0, nv, sv)[None, :]).reshape(-1)
            levels.append(Level(su, sv, level_error(grid, su, sv), positions[keep].astype(np.float32),
                                normals[keep].astype(np.float32), uvs[keep].astype(np.float32),
                                grid_faces(nu // su, nv // sv)))
    levels.sort(key=lambda lv: (len(lv.faces), lv.error))
    # keep a level only where no cheaper level is as fine
    out, best = [], np.inf
    for lv in levels:
        if lv.error < best:
            out.append(lv)
            best = lv.error
    return out[::-1]


def pick_level(errors: np.ndarray, allowed):
    """Index of the cheapest level whose error is under `allowed` (levels
    ordered finest first, errors falling), the finest where none is."""
    import torch

    e = torch.as_tensor(errors, dtype=torch.float32, device=allowed.device)
    ok = e[None, :] < allowed[:, None]
    idx = torch.arange(len(errors), device=allowed.device)[None, :]
    return torch.where(ok, idx, 0).amax(dim=1)
