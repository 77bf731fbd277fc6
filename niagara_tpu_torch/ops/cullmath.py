"""Culling and shading math on tensors (niagara_tpu/ops/cullmath.py).

Shape-polymorphic over leading batch dimensions, float32.  Sums of
products are written out left to right instead of going through `matmul` /
`sum`, so the plain torch op order is explicit and the same on every device.
"""

from __future__ import annotations

import torch


def rdiv(x: float, t: torch.Tensor) -> torch.Tensor:
    """x / t as one IEEE division.  `float / tensor` in torch computes
    reciprocal(t) * x, two roundings, where the reference and the CUDA
    kernels divide once."""
    return torch.full_like(t, x) / t


def div(t: torch.Tensor, x: float) -> torch.Tensor:
    """t / x as one IEEE division on every device: on a CUDA tensor, torch's
    `tensor / float` multiplies by the reciprocal (two roundings)."""
    return t / torch.full_like(t, x)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot3(a: torch.Tensor, b) -> torch.Tensor:
    """a . b over the last axis; b is a tensor or three host numbers."""
    b0, b1, b2 = (b[..., 0], b[..., 1], b[..., 2]) if torch.is_tensor(b) else b
    return a[..., 0] * b0 + a[..., 1] * b1 + a[..., 2] * b2


def rotate_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """v + 2*cross(q.xyz, cross(q.xyz, v) + q.w*v)  (cullmath.py:13)."""
    qv = q[..., :3]
    t = cross(qv, v) + q[..., 3:4] * v
    return v + 2.0 * cross(qv, t)


def view_transform(p: torch.Tensor, view, translate: bool = True) -> torch.Tensor:
    """p @ view[:3,:3].T (+ view[:3,3]) for a host [4,4] view matrix."""
    rows = []
    for i in range(3):
        r = p[..., 0] * float(view[i, 0]) + p[..., 1] * float(view[i, 1]) + p[..., 2] * float(view[i, 2])
        rows.append(r + float(view[i, 3]) if translate else r)
    return torch.stack(rows, dim=-1)


def project_sphere(c: torch.Tensor, r: torch.Tensor, znear: float, p00: float, p11: float):
    """Mara-McGuire projected sphere bounds (cullmath.py:21): (valid, aabb
    [...,4] in uv space)."""
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    valid = cz >= r + znear
    czr2 = cz * cz - r * r
    vx = torch.sqrt(torch.clamp_min(cx * cx + czr2, 0.0))
    minx = (vx * cx - cz * r) / (vx * cz + cx * r)
    maxx = (vx * cx + cz * r) / (vx * cz - cx * r)
    vy = torch.sqrt(torch.clamp_min(cy * cy + czr2, 0.0))
    miny = (vy * cy - cz * r) / (vy * cz + cy * r)
    maxy = (vy * cy + cz * r) / (vy * cz - cy * r)
    aabb = torch.stack(
        [minx * p00 * 0.5 + 0.5, maxy * p11 * -0.5 + 0.5, maxx * p00 * 0.5 + 0.5, miny * p11 * -0.5 + 0.5],
        dim=-1,
    )
    return valid, aabb


def occlusion_mip(aabb: torch.Tensor, pyramid_width: float, pyramid_height: float) -> torch.Tensor:
    """Mip level for the 2x2 min-sampled occlusion test (cullmath.py:54)."""
    size_x = (aabb[..., 2] - aabb[..., 0]) * pyramid_width
    size_y = (aabb[..., 3] - aabb[..., 1]) * pyramid_height
    level = torch.ceil(torch.log2(torch.clamp_min(torch.maximum(size_x, size_y), 1e-12)))
    fmip_w = pyramid_width * torch.exp2(1.0 - level)
    fmip_h = pyramid_height * torch.exp2(1.0 - level)
    fx = aabb[..., 0] * fmip_w
    fy = aabb[..., 1] * fmip_h
    fits = ((fx - torch.floor(fx)) + (aabb[..., 2] - aabb[..., 0]) * fmip_w <= 2.0) & (
        (fy - torch.floor(fy)) + (aabb[..., 3] - aabb[..., 1]) * fmip_h <= 2.0
    )
    return torch.clamp_min(level - fits.to(level.dtype), 0.0)


def cone_cull(center, radius, cone_axis, cone_cutoff) -> torch.Tensor:
    """True when the whole meshlet faces away from a camera at the view-space
    origin (cullmath.py:73)."""
    dist = torch.sqrt(dot3(center, center))
    return dot3(center, cone_axis) >= cone_cutoff * dist + radius


def frustum_visible(center, radius, frustum, znear: float, zfar: float) -> torch.Tensor:
    """Symmetric-plane frustum test on view-space spheres (cullmath.py:80)."""
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    f0, f1, f2, f3 = (float(x) for x in frustum)
    vis = cz * f1 - torch.abs(cx) * f0 > -radius
    vis &= cz * f3 - torch.abs(cy) * f2 > -radius
    vis &= (cz + radius > znear) & (cz - radius < zfar)
    return vis


def sample_pyramid_min(atlas: torch.Tensor, uv: torch.Tensor, level: torch.Tensor, base_w: int, base_h: int):
    """Min of the 2x2 footprint at `uv` in mip `level` of the footprint-
    filtered pyramid atlas [L, base_h, base_w] (cullmath.py:90)."""
    lvl = level.to(torch.int64)
    shift = torch.clamp(lvl, 0, 62)  # int32 shifts past the width give 0 in XLA, as these do
    mip_w = torch.clamp_min(torch.full_like(lvl, base_w) >> shift, 1)
    mip_h = torch.clamp_min(torch.full_like(lvl, base_h) >> shift, 1)
    x0 = torch.floor(uv[..., 0] * mip_w.to(torch.float32) - 0.5).to(torch.int64)
    y0 = torch.floor(uv[..., 1] * mip_h.to(torch.float32) - 0.5).to(torch.int64)
    xc = torch.minimum(torch.clamp_min(x0, 0), mip_w - 1)
    yc = torch.minimum(torch.clamp_min(y0, 0), mip_h - 1)
    flat = atlas.reshape(-1)
    # out-of-range gathers clamp, as XLA's do (levels past the last mip)
    return flat[torch.clamp((lvl * base_h + yc) * base_w + xc, 0, flat.shape[0] - 1)]


def oct_encode(v: torch.Tensor) -> torch.Tensor:
    """Octahedral normal encode, zero-guarded (cullmath.py:116)."""
    denom = torch.abs(v[..., 0]) + torch.abs(v[..., 1]) + torch.abs(v[..., 2])
    p = v[..., :2] / torch.clamp_min(denom[..., None], 1e-20)
    s = torch.where(v[..., :2] >= 0, 1.0, -1.0)
    return torch.where((v[..., 2] <= 0)[..., None], (1.0 - torch.abs(p.flip(-1))) * s, p)


def oct_decode(e: torch.Tensor) -> torch.Tensor:
    vz = 1.0 - torch.abs(e[..., 0]) - torch.abs(e[..., 1])
    t = torch.clamp_min(-vz, 0.0)
    vx = e[..., 0] + torch.where(e[..., 0] >= 0, -t, t)
    vy = e[..., 1] + torch.where(e[..., 1] >= 0, -t, t)
    v = torch.stack([vx, vy, vz], dim=-1)
    n = torch.sqrt(dot3(v, v))[..., None]
    return v / torch.clamp_min(n, 1e-20)


def to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2)


def from_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp_min(c, 0.0), 2.2)


def tonemap(c: torch.Tensor) -> torch.Tensor:
    """Hejl/Burgess-Dawson filmic operator (cullmath.py:144)."""
    x = torch.clamp_min(c - 0.004, 0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def gradient_noise(uv: torch.Tensor) -> torch.Tensor:
    """Jimenez interleaved gradient noise (cullmath.py:150)."""
    a = uv[..., 0] * 0.06711056 + uv[..., 1] * 0.00583715
    f = 52.9829189 * (a - torch.trunc(a))
    return f - torch.trunc(f)
