"""Bloom: the downsample/upsample mip chain (niagara_tpu/ops/bloom.py).

The emissive part of the G-buffer is extracted at half resolution
(`extract_emissive`), filtered down the chain by the 13-tap Jimenez
downsample (`_down2`), accumulated back up it by the 9-tap tent upsample
(`_up2`, each level plus the finer mip) and expanded to full resolution
bilinearly (`_bilinear_x2`); the composite adds `bloom * 0.1`.  As in the
reference, each bilinear tap is expanded into an exact fixed stencil
(`_DOWN_K` 6x6, `_UP_K` four 5x5 phases) with edge clamping, layout
channel-first [3, h, w].

The plain versions keep the reference's tap order (`out = out + w * tap`
from 0, rows then columns, zero weights skipped).  On a CUDA tensor the
chain runs csrc/bloom.cu's kernels, which repeat those ops in that order
and equal them bit for bit: `bloom_down` and `bloom_up` (fused with the
accumulate) on the large levels, a level a launch; from `tail_start`, the
first level whose mips down to the last fit in TAIL_SPLIT_BYTES of shared
memory, `bloom_tail` runs every remaining down and up in one launch (its
plain twin `tail_plain`); `bloom_x2` writes the [H, W, 3] image.  At
1920x1080 that is 10 launches a frame (4 downs, the tail from mip 4, 4
ups, the expansion); at 256x128 4 (the tail from mip 1).  The chain's
launches are dependent launches (csrc/bloom.cu).  The emissive extract
stays plain torch on both devices (its pow and exp2 come from each
device's math library).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..utils.math3d import image_mip_levels
from . import cullmath

# 13-tap Jimenez downsample: (dx, dy, weight) at half-texel bilinear positions
_DOWN_TAPS = (
    [(0, 0, 0.125)]
    + [(dx, dy, 0.03125) for dx in (-2, 2) for dy in (-2, 2)]
    + [(0, -2, 0.0625), (0, 2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625)]
    + [(dx, dy, 0.125) for dx in (-1, 1) for dy in (-1, 1)]
)

# 9-tap tent upsample
_UP_TAPS = (
    [(0, 0, 0.25)]
    + [(d, 0, 0.125) for d in (-1, 1)]
    + [(0, d, 0.125) for d in (-1, 1)]
    + [(dx, dy, 0.0625) for dx in (-1, 1) for dy in (-1, 1)]
)


def _down_kernel():
    """The 13 bilinear taps as a 6x6 source-texel stencil for exact 2:1
    downsampling: output (x, y) reads source (2x+i-2, 2y+j-2) (bloom.py:43)."""
    k = np.zeros((6, 6), np.float64)
    for dx, dy, w in _DOWN_TAPS:
        for i in (dx, dx + 1):
            for j in (dy, dy + 1):
                k[j + 2, i + 2] += w * 0.25
    return k


def _up_kernels():
    """Phase stencils (5x5, keyed (py, px)) for exact 1:2 tent upsampling:
    output (2k+px, 2l+py) reads source texels around (k, l) (bloom.py:55)."""
    ks = {}
    for px in (0, 1):
        for py in (0, 1):
            k = np.zeros((5, 5), np.float64)
            for dx, dy, w in _UP_TAPS:
                sx = (px + 0.5) / 2.0 + dx - 0.5
                sy = (py + 0.5) / 2.0 + dy - 0.5
                x0, fx = int(np.floor(sx)), sx - np.floor(sx)
                y0, fy = int(np.floor(sy)), sy - np.floor(sy)
                for i, wx in ((x0, 1 - fx), (x0 + 1, fx)):
                    for j, wy in ((y0, 1 - fy), (y0 + 1, fy)):
                        k[j + 2, i + 2] += w * wx * wy
            ks[(py, px)] = k
    return ks


def _x2_taps():
    """Per phase (py, px) of the 1:2 bilinear expansion: its four taps
    (column offset, row offset, weight) in the reference's order, columns
    outer (bloom.py:186-197)."""
    taps = {}
    for py in (0, 1):
        for px in (0, 1):
            sx = (px + 0.5) / 2.0 - 0.5
            sy = (py + 0.5) / 2.0 - 0.5
            x0, fx = int(np.floor(sx)), sx - np.floor(sx)
            y0, fy = int(np.floor(sy)), sy - np.floor(sy)
            taps[(py, px)] = [(i, j, wx * wy) for i, wx in ((x0, 1 - fx), (x0 + 1, fx))
                              for j, wy in ((y0, 1 - fy), (y0 + 1, fy))]
    return taps


_DOWN_K = _down_kernel()
_UP_K = _up_kernels()
_X2_TAPS = _x2_taps()


def bloom_levels(width: int, height: int) -> int:
    bw, bh = (width + 1) // 2, (height + 1) // 2
    return min(8, image_mip_levels(bw, bh))


def _clamped(src, top: int, bottom: int, left: int, right: int):
    """src [C, h, w] edge-padded by the given rows and columns (index
    clamping: the reference's `jnp.pad(mode="edge")`)."""
    if not (top or bottom or left or right):
        return src
    _, h, w = src.shape
    rows = torch.clamp(torch.arange(-top, h + bottom, device=src.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=src.device), 0, w - 1)
    return src[:, rows][:, :, cols]


def _interleave_phases(phases, h, w):
    """out[:, 2y+py, 2x+px] = phases[(py, px)][:, y, x] (bloom.py:136)."""
    c = phases[(0, 0)].shape[0]
    rows = [torch.stack([phases[(py, 0)], phases[(py, 1)]], dim=-1).reshape(c, h, w * 2) for py in (0, 1)]
    return torch.stack(rows, dim=2).reshape(c, h * 2, w * 2)


def _down2(src):
    """Exact 13-tap downsample by 2 (stencil form), [C,h,w] ->
    [C,(h+1)/2,(w+1)/2]; odd sizes edge-padded to even first (bloom.py:95)."""
    _, h, w = src.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    p = _clamped(src, 2, 2 * oh - h + 4, 2, 2 * ow - w + 4)
    out = torch.zeros((src.shape[0], oh, ow), dtype=src.dtype, device=src.device)
    for j in range(6):
        for i in range(6):
            wgt = float(_DOWN_K[j, i])
            if wgt == 0.0:
                continue
            out = out + wgt * p[:, j:j + 2 * oh:2, i:i + 2 * ow:2]
    return out


def _up2(src, oh: int, ow: int):
    """Exact 9-tap tent upsample to (oh, ow) (stencil phase form), [C,h,w]
    (bloom.py:119)."""
    _, h, w = src.shape
    p = _clamped(src, 2, 2, 2, 2)
    phases = {}
    for (py, px), k in _UP_K.items():
        acc = 0.0
        for j in range(5):
            for i in range(5):
                wgt = float(k[j, i])
                if wgt == 0.0:
                    continue
                acc = acc + wgt * p[:, j:j + h, i:i + w]
        phases[(py, px)] = acc
    return _interleave_phases(phases, h, w)[:, :oh, :ow]


def up2_add_plain(src, mip):
    """One level of the up chain: `mip + _up2(src)` at mip's size
    (bloom.py:167-169)."""
    return mip + _up2(src, *mip.shape[1:])


def _bilinear_x2(src, oh: int, ow: int):
    """Exact 1:2 bilinear upsample (phase weights 0.25/0.75) to (oh, ow),
    [C,h,w] (bloom.py:180)."""
    _, h, w = src.shape
    p = _clamped(src, 1, 1, 1, 1)
    phases = {}
    for (py, px), taps in _X2_TAPS.items():
        v = 0.0
        for i, j, wgt in taps:
            v = v + wgt * p[:, 1 + j:1 + j + h, 1 + i:1 + i + w]
        phases[(py, px)] = v
    return _interleave_phases(phases, h, w)[:, :oh, :ow]


def extract_emissive(g0, width: int, height: int):
    """Phase 0: the emissive color decoded from g0 [H,W,4], box-filtered to
    half resolution, [3, bh, bw] (bloom.py:148).  The 2x2 sum runs in the
    order ((a + b) + c) + d over (dy, dx) = (0,0), (0,1), (1,0), (1,1), the
    reference's reduction order."""
    albedo = cullmath.from_srgb(g0[..., :3])
    emissive = (albedo * (torch.exp2(g0[..., 3] * 5.0) - 1.0)[..., None]).permute(2, 0, 1)
    _, h, w = emissive.shape
    e = _clamped(emissive, 0, h % 2, 0, w % 2)
    return 0.25 * (((e[:, 0::2, 0::2] + e[:, 0::2, 1::2]) + e[:, 1::2, 0::2]) + e[:, 1::2, 1::2])


def bloom_chain(g0, width: int, height: int, down, up_add):
    """The chain with the given level filters: `down(mip)` one level down,
    `up_add(acc, mip)` one level up plus the finer mip.  Returns the
    half-resolution bloom [3, bh, bw] (bloom.py:160)."""
    levels = bloom_levels(width, height)
    mips = [extract_emissive(g0, width, height)]
    for _ in range(1, levels):
        mips.append(down(mips[-1]))
    acc = mips[-1]
    for i in range(levels - 2, -1, -1):
        acc = up_add(acc, mips[i])
    return acc


# What the tail can hold: the most dynamic shared memory an H100 block may
# hold (227 KB, kTailMaxSmem in csrc/bloom.cu).
TAIL_SMEM_BYTES = 232_448
# Where the chain splits: the tail starts at the first level whose mips down
# to the last fit in 48 KB.  The down and up chain at 1920x1080 on the H100
# (PERF.md §6, `python3 chip_sweep.py bloom`; device ms of 20
# chains, then ms a chain of 100 back to back): the tail from mip 4 (32.7 KB)
# 0.0505, 0.0505; from mip 5 0.0492, 0.0920; from mip 3 (130.6 KB, within
# the 227 KB the tail holds) 0.0651, 0.0650; no tail 0.0508, 0.1441 (14
# launches: past the launch queue the host paces them).  A mip 3 tail takes
# 0.0308 ms on one SM where its 8 levels a launch take 0.0215.
TAIL_SPLIT_BYTES = 49_152
_TAIL_ALIGN = 64  # floats: each level of the tail's output starts 256-byte aligned


def level_sizes(h: int, w: int, n: int) -> list[tuple[int, int]]:
    """The sizes of n levels of the chain from an h x w mip: each level is
    half the one above, rounded up (`_down2`)."""
    sizes = [(h, w)]
    for _ in range(1, n):
        h, w = (h + 1) // 2, (w + 1) // 2
        sizes.append((h, w))
    return sizes


def _tail_smem_bytes(sizes) -> int:
    """Shared memory the tail takes for these levels: each level's three
    planes, 16-byte aligned (bloom_tail_launch)."""
    return sum((3 * h * w + 3) // 4 * 4 for h, w in sizes) * 4


@functools.lru_cache(maxsize=16)
def tail_start(levels: int, h: int, w: int) -> int:
    """The first level of the chain from an h x w mip 0 whose mips down to
    the last fit in TAIL_SPLIT_BYTES of shared memory; `levels` if none
    does.  The tail runs when it has at least two levels."""
    sizes = level_sizes(h, w, levels)
    return next((k for k in range(levels) if _tail_smem_bytes(sizes[k:]) <= TAIL_SPLIT_BYTES), levels)


def split_chain(mip0, levels: int, start: int, down, up_add, tail):
    """The chain from mip 0 split at `start` (capped at the last level):
    `down` to level start, `tail(mips[start], levels - start)` (its written
    levels, the last being the accumulated level start) where that holds at
    least two levels, then `up_add` back to level 0.  Returns the
    half-resolution bloom."""
    start = min(start, levels - 1)
    mips = [mip0]
    for _ in range(start):
        mips.append(down(mips[-1]))
    acc = tail(mips[start], levels - start)[-1] if levels - start >= 2 else mips[start]
    for i in range(start - 1, -1, -1):
        acc = up_add(acc, mips[i])
    return acc


def tail_plain(src, n: int) -> list:
    """The tail's levels from src (the chain's level `start`, n levels):
    `_down2` to each level below, then `up2_add_plain` back up; returns
    what bloom_tail writes, in its order: the downs' levels 1..n-1, then
    the ups' levels n-2..0 (the last is the tail's result)."""
    mips = [src]
    for _ in range(1, n):
        mips.append(_down2(mips[-1]))
    written, acc = mips[1:], mips[-1]
    for mip in mips[-2::-1]:
        acc = up2_add_plain(acc, mip)
        written.append(acc)
    return written


def cuda_chain(mip0, levels: int):
    """The chain from mip 0 on bloom.cu's kernels: the large levels a level
    a launch, the tail from `tail_start` in one."""
    return split_chain(mip0, levels, tail_start(levels, *mip0.shape[1:]), down2_cuda, up2_add_cuda, tail_cuda)


def compute_bloom(g0, width: int, height: int):
    """Full bloom chain; returns the half-res bloom image [3, bh, bw]: the
    plain filters on a CPU tensor, bloom.cu's kernels on a CUDA one."""
    if g0.device.type == "cpu":
        return bloom_chain(g0, width, height, _down2, up2_add_plain)
    return cuda_chain(extract_emissive(g0, width, height), bloom_levels(width, height))


def sample_bloom_fullres(bloom_half, width: int, height: int):
    """Bilinear expansion of the half-res bloom to full resolution [H,W,3]
    (bloom.py:174): `_bilinear_x2` on a CPU tensor, the bloom_x2 kernel on
    a CUDA one."""
    if bloom_half.device.type == "cpu":
        return _bilinear_x2(bloom_half, height, width).permute(1, 2, 0)
    return bilinear_x2_cuda(bloom_half, height, width)


# ---------------------------------------------------------------- kernels


def _weights():
    """The plain versions' tables as bloom.cu's by-value structs."""
    down = _build.DownWeights()
    down.w[:] = [float(x) for x in _DOWN_K.reshape(-1)]
    up = _build.UpWeights()
    blocks = []
    for py in (0, 1):
        for px in (0, 1):
            k = _UP_K[(py, px)]
            block = k[py:py + 4, px:px + 4]
            # each phase's nonzero taps fill this 4x4 block, so the kernel's
            # row-major walk over it is the plain version's walk over k
            assert np.count_nonzero(k) == np.count_nonzero(block) == 16
            blocks += [float(x) for x in block.reshape(-1)]
    up.w[:] = blocks
    x2 = _build.X2Weights()
    order = []
    for py in (0, 1):
        for px in (0, 1):
            taps = _X2_TAPS[(py, px)]
            # columns px - 1, px (outer), rows py - 1, py (inner)
            assert [(i, j) for i, j, _ in taps] == [(px - 1 + a, py - 1 + b) for a in (0, 1) for b in (0, 1)]
            order += [float(wgt) for _, _, wgt in taps]
    x2.w[:] = order
    return down, up, x2


_DOWN_W, _UP_W, _X2_W = _weights()


def _expect_image(t, what: str):
    if t.dim() != 3 or t.shape[0] != 3 or t.dtype != torch.float32 or t.device.type != "cuda":
        raise ValueError(f"{what}: expected float32 [3, h, w] on cuda, got {t.dtype} {tuple(t.shape)} on {t.device}")


def down2_cuda(src):
    """The bloom_down kernel (csrc/bloom.cu): `_down2`'s contract on a
    [3, h, w] image."""
    _build.require_cuda(src, "bloom_down")
    _expect_image(src, "bloom_down source")
    src = src.contiguous()
    c, h, w = src.shape
    out = torch.empty((c, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=src.device)
    rc = _build.lib().bloom_down_launch(src.data_ptr(), c, h, w, out.data_ptr(), _DOWN_W,
                                        _build.stream_ptr(src))
    _build.LAUNCHES["bloom_down"] += 1
    _build.check(rc, "bloom_down")
    return out


def up2_add_cuda(src, mip):
    """The bloom_up kernel (csrc/bloom.cu): `up2_add_plain`'s contract on
    [3, h, w] images."""
    _build.require_cuda(src, "bloom_up")
    _expect_image(src, "bloom_up source")
    _expect_image(mip, "bloom_up mip")
    src, mip = src.contiguous(), mip.contiguous()
    c, h, w = src.shape
    _, oh, ow = mip.shape
    if mip.shape[0] != c or oh > 2 * h or ow > 2 * w:
        raise ValueError(f"bloom_up: mip {tuple(mip.shape)} is not an up level of {tuple(src.shape)}")
    out = torch.empty_like(mip)
    rc = _build.lib().bloom_up_launch(src.data_ptr(), c, h, w, mip.data_ptr(), out.data_ptr(), oh, ow,
                                      _UP_W, _build.stream_ptr(src))
    _build.LAUNCHES["bloom_up"] += 1
    _build.check(rc, "bloom_up")
    return out


@functools.lru_cache(maxsize=16)
def tail_layout(h: int, w: int, n: int):
    """The tail's TailLevels for n levels from an h x w source, the floats
    of its output and, in tail_plain's order, each written level's
    (offset, (h, w)).  Raises ValueError where they do not fit the tail."""
    sizes = level_sizes(h, w, n)
    if not 2 <= n <= 8 or _tail_smem_bytes(sizes) > TAIL_SMEM_BYTES:
        raise ValueError(f"bloom_tail: {n} levels from {h}x{w} do not fit its shared memory")
    levels = _build.TailLevels()
    levels.n = n
    levels.h[:n] = [s[0] for s in sizes]
    levels.w[:n] = [s[1] for s in sizes]
    written, off = [], 0
    for k, field in [(k, "down_off") for k in range(1, n)] + [(k, "up_off") for k in range(n - 2, -1, -1)]:
        getattr(levels, field)[k] = off
        written.append((off, sizes[k]))
        off += (3 * sizes[k][0] * sizes[k][1] + _TAIL_ALIGN - 1) // _TAIL_ALIGN * _TAIL_ALIGN
    return levels, off, written


def tail_cuda(src, n: int) -> list:
    """The bloom_tail kernel (csrc/bloom.cu): `tail_plain`'s contract."""
    _build.require_cuda(src, "bloom_tail")
    _expect_image(src, "bloom_tail source")
    src = src.contiguous()
    _, h, w = src.shape
    levels, floats, written = tail_layout(h, w, n)
    out = torch.empty(floats, dtype=torch.float32, device=src.device)
    rc = _build.lib().bloom_tail_launch(src.data_ptr(), out.data_ptr(), levels, _DOWN_W, _UP_W,
                                        _build.stream_ptr(src))
    _build.LAUNCHES["bloom_tail"] += 1
    _build.check(rc, "bloom_tail")
    return [out[off:off + 3 * lh * lw].view(3, lh, lw) for off, (lh, lw) in written]


def bilinear_x2_cuda(src, oh: int, ow: int):
    """The bloom_x2 kernel (csrc/bloom.cu): `_bilinear_x2`'s contract,
    written as [oh, ow, 3]."""
    _build.require_cuda(src, "bloom_x2")
    _expect_image(src, "bloom_x2 source")
    src = src.contiguous()
    c, h, w = src.shape
    if c != 3 or oh > 2 * h or ow > 2 * w:
        raise ValueError(f"bloom_x2: cannot expand {tuple(src.shape)} to {oh}x{ow}x3")
    out = torch.empty((oh, ow, 3), dtype=torch.float32, device=src.device)
    rc = _build.lib().bloom_x2_launch(src.data_ptr(), c, h, w, out.data_ptr(), oh, ow, _X2_W,
                                      _build.stream_ptr(src))
    _build.LAUNCHES["bloom_x2"] += 1
    _build.check(rc, "bloom_x2")
    return out
