"""Depth pyramid (HiZ) for the late pass's occlusion tests
(niagara_tpu/ops/pyramid.py).

Atlas [levels, PH, PW] of min-reduced mips (reverse-Z: min = farthest),
mip l valid in [:PH>>l, :PW>>l]; every texel holds the min of its 2x2
footprint, so the occlusion test's 2x2 min sample is one gather.  Only
min and index selection happen here, so values equal the reference's bit
for bit.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..utils.math3d import image_mip_levels, previous_pow2


def pyramid_shape(width: int, height: int) -> tuple[int, int, int]:
    """(levels, PH, PW) for a framebuffer of size width x height."""
    pw, ph = previous_pow2(width), previous_pow2(height)
    return image_mip_levels(pw, ph), ph, pw


@functools.lru_cache(maxsize=None)
def _nearest_index(out_n: int, in_n: int, device: torch.device) -> torch.Tensor:
    """Source texel per output texel: floor((j+0.5)*in/out - 0.5), clamped
    within its gcd period (pyramid.py:56-70).  Cached: one host-to-device
    copy per shape, not one per frame."""
    g = math.gcd(out_n, in_n)
    q, p = out_n // g, in_n // g
    idx = [min(max(math.floor((j + 0.5) * in_n / out_n - 0.5), 0), p - 1) for j in range(q)]
    return torch.tensor([grp * p + i for grp in range(g) for i in idx], device=device)


def _shift_min(a: torch.Tensor, dim: int) -> torch.Tensor:
    """min over a[i], a[i+1], a[i+2] along `dim`, clamped at the end."""
    def sh(b):
        return torch.cat([b.narrow(dim, 1, b.shape[dim] - 1), b.narrow(dim, b.shape[dim] - 1, 1)], dim=dim)

    s1 = sh(a)
    return torch.minimum(a, torch.minimum(s1, sh(s1)))


def _min_sample_reduce(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    in_h, in_w = src.shape
    if in_h == out_h * 2 and in_w == out_w * 2:
        return src.reshape(out_h, 2, out_w, 2).amin(dim=(1, 3))
    # non-pow2 base step: 3x3 shifted min, then one nearest texel each
    f = _shift_min(_shift_min(src, 0), 1)
    return f[:, _nearest_index(out_w, in_w, src.device)][_nearest_index(out_h, in_h, src.device), :]


def build_pyramid(depth: torch.Tensor, levels: int, ph: int, pw: int) -> torch.Tensor:
    """depth [H,W] -> footprint-filtered atlas [levels, ph, pw]."""
    mips = []
    src, h, w = depth, ph, pw
    for _ in range(levels):
        mip = _min_sample_reduce(src, h, w)
        right = torch.cat([mip[:, 1:], mip[:, -1:]], dim=1)
        down = torch.cat([mip[1:, :], mip[-1:, :]], dim=0)
        downright = torch.cat([right[1:, :], right[-1:, :]], dim=0)
        filtered = torch.minimum(torch.minimum(mip, right), torch.minimum(down, downright))
        mips.append(F.pad(filtered, (0, pw - w, 0, ph - h)))
        src, h, w = mip, max(h // 2, 1), max(w // 2, 1)
    return torch.stack(mips, dim=0)
