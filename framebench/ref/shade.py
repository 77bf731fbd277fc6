"""Texturing and lighting of a surface point, as the renderer defines them.

Textures: bilinear filtering with repeat wrap at one mip level, the level
floor(log2 of the texel-to-pixel footprint's side), clamped to the chain;
albedo texels are sRGB (2.2 gamma).  Lighting: the sun's N.L times 2.5,
scaled by its visibility (the shadow term plus 0.05 of sky fill, at most
1), a Blinn-Phong highlight (exponent 1 + 63 gloss, weight gloss) times
2.5 and the visibility, and 0.07 of ambient; then the Hejl/Burgess-Dawson
filmic tone curve.  Uncovered pixels are black.
"""

from __future__ import annotations

import math

import torch

SUN_INTENSITY, AMBIENT, SKY_FILL = 2.5, 0.07, 0.05


def mip_level(uv_area_per_px_area, texels: int, levels: int):
    """The mip whose texel covers about one pixel: floor(0.5 log2(uv area a
    pixel * texel count)), clamped to [0, levels - 1]."""
    ratio = torch.clamp_min(uv_area_per_px_area * texels, 1.0)
    return torch.clamp(torch.floor(0.5 * torch.log2(ratio)), 0, levels - 1).to(torch.int64)


def sample(chain: list, uv, mip):
    """Bilinear samples [K, 4] of a texture's mip chain (device tensors
    [h, w, 4] in [0, 1]) at uvs [K, 2] and levels [K]."""
    out = torch.zeros((len(uv), 4), dtype=torch.float32, device=uv.device)
    for m in torch.unique(mip).tolist():
        sel = torch.nonzero(mip == m).squeeze(1)
        tex = chain[m]
        h, w = tex.shape[:2]
        x = (uv[sel, 0] - torch.floor(uv[sel, 0])) * w - 0.5
        y = (uv[sel, 1] - torch.floor(uv[sel, 1])) * h - 0.5
        xf, yf = torch.floor(x), torch.floor(y)
        fx, fy = (x - xf)[:, None], (y - yf)[:, None]
        xi, yi = xf.to(torch.int64), yf.to(torch.int64)

        def at(dx, dy):
            return tex[torch.remainder(yi + dy, h), torch.remainder(xi + dx, w)]

        out[sel] = (at(0, 0) * (1 - fx) + at(1, 0) * fx) * (1 - fy) + (at(0, 1) * (1 - fx) + at(1, 1) * fx) * fy
    return out


def tone(c):
    x = torch.clamp_min(c - 0.004, 0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def lit(albedo, normal, point, camera, sun, gloss, shadow):
    """Tone-mapped colour [K, 3] of points with linear albedo [K, 3], unit
    normals [K, 3], world positions [K, 3], gloss [K] and sun visibility
    [K] in [0, 1], seen from `camera` [3] under the unit `sun` [3]."""
    ndotl = torch.clamp_min(normal @ sun, 0.0)
    view = camera[None, :] - point
    view = view / torch.clamp_min(view.norm(dim=-1, keepdim=True), 1e-20)
    half = view + sun[None, :]
    half = half / torch.clamp_min(half.norm(dim=-1, keepdim=True), 1e-20)
    ndoth = torch.clamp_min((normal * half).sum(-1), 1e-6)
    spec = ndoth ** (1.0 + 63.0 * gloss) * gloss * shadow
    light = ndotl * torch.clamp_max(shadow + SKY_FILL, 1.0) * SUN_INTENSITY + AMBIENT
    return tone(albedo * light[:, None] + (spec * SUN_INTENSITY)[:, None])


def quat_matrix(q):
    """Rotation matrices [N, 3, 3] of unit quaternions (x, y, z, w) [N, 4]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def focal(fov_y: float, width: int, height: int) -> tuple[float, float]:
    """(p00, p11): the projection's x and y scales."""
    f = 1.0 / math.tan(fov_y / 2.0)
    return f * height / width, f
