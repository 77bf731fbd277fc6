"""Depth pyramid (HiZ) for the late pass's occlusion tests
(niagara_tpu/ops/pyramid.py).

Atlas [levels, PH, PW] of min-reduced mips (reverse-Z: min = farthest),
mip l valid in [:PH>>l, :PW>>l]; every texel holds the min of its 2x2
footprint, so the occlusion test's 2x2 min sample is one gather.  Only
min and index selection happen here, so values equal the reference's bit
for bit.  `build_pyramid` runs `build_pyramid_plain` on CPU tensors and
`pyramid_cuda` (csrc/cull.cu's pyramid_base_kernel and
pyramid_filter_kernel, the same atlas bit for bit) on CUDA tensors.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import _build
from ..utils.math3d import image_mip_levels, previous_pow2


def pyramid_shape(width: int, height: int) -> tuple[int, int, int]:
    """(levels, PH, PW) for a framebuffer of size width x height."""
    pw, ph = previous_pow2(width), previous_pow2(height)
    return image_mip_levels(pw, ph), ph, pw


def _nearest(out_n: int, in_n: int) -> list:
    """Source texel per output texel: floor((j+0.5)*in/out - 0.5), clamped
    within its gcd period (pyramid.py:56-70)."""
    g = math.gcd(out_n, in_n)
    q, p = out_n // g, in_n // g
    idx = [min(max(math.floor((j + 0.5) * in_n / out_n - 0.5), 0), p - 1) for j in range(q)]
    return [grp * p + i for grp in range(g) for i in idx]


@functools.lru_cache(maxsize=None)
def _nearest_index(out_n: int, in_n: int, device: torch.device) -> torch.Tensor:
    """_nearest on `device`.  Cached: one host-to-device copy per shape,
    not one per frame."""
    return torch.tensor(_nearest(out_n, in_n), device=device)


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
    """depth [H,W] -> footprint-filtered atlas [levels, ph, pw]: the plain
    version on CPU tensors, the kernels on CUDA tensors."""
    if depth.device.type == "cpu":
        return build_pyramid_plain(depth, levels, ph, pw)
    return pyramid_cuda(depth, levels, ph, pw)


@functools.lru_cache(maxsize=None)
def _plan(in_h: int, in_w: int, levels: int, ph: int, pw: int):
    """The kernels' plan for a depth [in_h, in_w]: (PyramidPlan, the
    nearest-texel tables of the levels that do not halve their source
    exactly, texels of the levels the tiles build).  Raises ValueError
    where the first level below the tiles outgrows pyramid_filter_kernel's
    block."""
    plan = _build.PyramidPlan(levels=levels, in_h=in_h, in_w=in_w, ph=ph, pw=pw)
    table, src, hw = [], (in_h, in_w), (ph, pw)
    for lvl in range(levels):
        plan.h[lvl], plan.w[lvl] = hw
        plan.two_x[lvl] = int(src == (2 * hw[0], 2 * hw[1]))
        if not plan.two_x[lvl]:
            plan.ny[lvl] = len(table)
            table += _nearest(hw[0], src[0])
            plan.nx[lvl] = len(table)
            table += _nearest(hw[1], src[1])
        src, hw = hw, (max(hw[0] // 2, 1), max(hw[1] // 2, 1))
    while plan.lt < min(levels - 1, _build.PYRAMID_TILE_LEVELS) and plan.two_x[plan.lt + 1]:
        plan.lt += 1
    size = 0
    for lvl in range(plan.lt + 1):
        plan.uoff[lvl] = size
        size += plan.h[lvl] * plan.w[lvl]
    tail = max((plan.h[lvl] * plan.w[lvl] for lvl in range(plan.lt + 1, levels)), default=0)
    if tail > _build.PYRAMID_TAIL_MAX:
        raise ValueError(f"pyramid: a level of {tail} texels below the tiles (the kernel holds "
                         f"{_build.PYRAMID_TAIL_MAX})")
    return plan, table or [0], size


def pyramid_cuda(depth: torch.Tensor, levels: int, ph: int, pw: int) -> torch.Tensor:
    """csrc/cull.cu's pyramid_base_kernel (level 0 and the tiles' halvings)
    and pyramid_filter_kernel (every level's footprint and the padding, the
    small levels in its block 0): build_pyramid_plain's atlas."""
    if depth.dtype != torch.float32 or depth.dim() != 2:
        raise ValueError(f"pyramid: expected a float32 [H, W] depth, got {depth.dtype} {tuple(depth.shape)}")
    H, W = depth.shape
    if not 1 <= levels <= _build.PYRAMID_LEVELS or not (1 <= ph <= H and 1 <= pw <= W):
        raise ValueError(f"pyramid: {levels} levels of {ph}x{pw} from {H}x{W} (1 to {_build.PYRAMID_LEVELS} "
                         "levels, no larger than the depth)")
    plan, _, size = _plan(H, W, levels, ph, pw)
    _build.require_cuda(depth, "pyramid")
    dev = depth.device
    index = _index_table(H, W, levels, ph, pw, dev)
    src = depth.contiguous()
    u = torch.empty(size, dtype=torch.float32, device=dev)
    atlas = torch.empty((levels, ph, pw), dtype=torch.float32, device=dev)
    lib, stream = _build.lib(), _build.stream_ptr(depth)
    rc = lib.pyramid_base_launch(src.data_ptr(), plan, index.data_ptr(), u.data_ptr(), stream)
    _build.LAUNCHES["pyramid_base"] += 1
    _build.check(rc, "pyramid_base")
    rc = lib.pyramid_filter_launch(plan, index.data_ptr(), u.data_ptr(), atlas.data_ptr(), stream)
    _build.LAUNCHES["pyramid_filter"] += 1
    _build.check(rc, "pyramid_filter")
    return atlas


@functools.lru_cache(maxsize=None)
def _index_table(in_h: int, in_w: int, levels: int, ph: int, pw: int, device: torch.device) -> torch.Tensor:
    """_plan's nearest-texel tables on `device`, copied once per shape."""
    return torch.tensor(_plan(in_h, in_w, levels, ph, pw)[1], dtype=torch.int32, device=device)


def build_pyramid_plain(depth: torch.Tensor, levels: int, ph: int, pw: int) -> torch.Tensor:
    """depth [H,W] -> footprint-filtered atlas [levels, ph, pw] in plain
    torch (pyramid_cuda's twin)."""
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
