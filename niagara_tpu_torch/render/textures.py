"""Texture table and sampling (niagara_tpu/render/textures.py).

Every texture's RGBA8 mip chain is packed into one flat texel pool;
sampling is address arithmetic plus gathers over the [H,W] shading grid.
`load_texture_mips` decodes DDS files through the port's C++ cooker (:50);
`build_texture_table` builds the table on the host in numpy (:72, from
pre-decoded mips); `to_device` moves it to a device; `sample` (:205) and
`select_mip_from_area` (:281) run on tensors.  Texel indices are integers
equal to the reference's; bilinear weights are f32 in the reference's
op order.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..cooker import bindings

MAX_MIPS = 14


@dataclass
class TextureTable:
    """numpy arrays from build_texture_table, tensors after to_device."""

    texels: object  # u8 [N, 4] flat texel pool (all textures, all mips)
    mip_offset: object  # i32 [NT, MAX_MIPS]
    mip_w: object  # i32 [NT, MAX_MIPS]
    mip_h: object  # i32 [NT, MAX_MIPS]
    mip_count: object  # i32 [NT]
    mip_rows: object  # i32 [NT*MAX_MIPS, 4]: offset, w, h, 0 per (texture, mip)
    # texel i's wrap-aware 2x2 bilinear footprint as one row (None past the
    # quad budget)
    texels_quad: object = None  # u8 [N, 16]


def _halve(img: np.ndarray) -> np.ndarray:
    """Floor-halving box downsample (textures.py:103)."""
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    crop = img[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1].astype(np.uint16)
    if h > 1:
        crop = (crop[0::2] + crop[1::2] + 1) // 2
    if w > 1:
        crop = (crop[:, 0::2] + crop[:, 1::2] + 1) // 2
    return crop.astype(np.uint8)


def _conforming(chain: list) -> list:
    """The chain with every mip's dims max(prev >> 1, 1): a non-conforming
    tail is regenerated by floor-halving from the last conforming level
    (textures.py:114), so any mip's (offset, w, h) follows from mip 0's."""
    out = [chain[0]]
    broke = False
    for m in chain[1:]:
        ph, pw = out[-1].shape[:2]
        if not broke and m.shape[0] == max(ph // 2, 1) and m.shape[1] == max(pw // 2, 1):
            out.append(m)
        else:
            broke = True
            out.append(_halve(out[-1]))
    return out


def load_texture_mips(paths: list[str], base_dir: str = "") -> tuple[list, list]:
    """Decode each DDS into its RGBA8 mip list (textures.py:50); a file that
    fails to decode becomes 1x1 magenta, with a warning.  Returns (mips,
    substituted): the lists that feed `build_texture_table` and the opacity
    bake, and the paths that were replaced by magenta, so a caller can
    refuse a scene with any."""
    out, substituted = [], []
    for p in paths:
        full = os.path.join(base_dir, p) if base_dir else p
        try:
            mips, _fmt = bindings.load_dds(full)
        except OSError as e:
            print(f"[textures] WARNING: {full}: {e} -- using 1x1 magenta", file=sys.stderr)
            mips = [np.tile(np.array([255, 0, 255, 255], np.uint8), (1, 1, 1))]
            substituted.append(full)
        out.append(mips[:MAX_MIPS])
    return out, substituted


def build_texture_table(mips: list, budget_bytes: int | None = 2 << 30,
                        quad_budget_bytes: int | None = 6 << 30) -> TextureTable:
    """One table from per-texture RGBA8 mip lists ([h,w,4] u8).  Texture 0
    is a 1x1 white dummy (id 0 = no texture).  Past `budget_bytes` the
    largest chains drop their finest mip, one level at a time."""
    texture_mips = [_conforming(c) for c in [[np.full((1, 1, 4), 255, np.uint8)]] + [list(m) for m in mips]]
    if budget_bytes is not None:
        def pool_size(tm):
            return sum(m.shape[0] * m.shape[1] * 4 for chain in tm for m in chain)

        while pool_size(texture_mips) > budget_bytes and any(len(m) > 1 for m in texture_mips):
            biggest = max(len(m) for m in texture_mips)
            texture_mips = [m[1:] if len(m) == biggest and len(m) > 1 else m for m in texture_mips]

    nt = len(texture_mips)
    mip_offset = np.zeros((nt, MAX_MIPS), np.int32)
    mip_w = np.ones((nt, MAX_MIPS), np.int32)
    mip_h = np.ones((nt, MAX_MIPS), np.int32)
    mip_count = np.zeros(nt, np.int32)
    chunks, quads = [], []
    offset = 0
    for t, chain in enumerate(texture_mips):
        mip_count[t] = len(chain)
        for m, img in enumerate(chain):
            h, w = img.shape[:2]
            mip_offset[t, m], mip_w[t, m], mip_h[t, m] = offset, w, h
            chunks.append(img.reshape(-1, 4))
            offset += w * h
            # quad row of texel (x, y): [p(x,y), p(x+1,y), p(x,y+1), p(x+1,y+1)], wrapping
            xr = np.concatenate([img[:, 1:], img[:, :1]], axis=1)
            yr = np.concatenate([img[1:, :], img[:1, :]], axis=0)
            xyr = np.concatenate([xr[1:, :], xr[:1, :]], axis=0)
            quads.append(np.concatenate([img, xr, yr, xyr], axis=-1).reshape(-1, 16))
        for m in range(len(chain), MAX_MIPS):  # out-of-range mips clamp to the coarsest
            mip_offset[t, m] = mip_offset[t, len(chain) - 1]
            mip_w[t, m] = mip_w[t, len(chain) - 1]
            mip_h[t, m] = mip_h[t, len(chain) - 1]
    texels = np.concatenate(chunks, axis=0)
    mip_rows = np.stack([mip_offset, mip_w, mip_h, np.zeros_like(mip_w)], axis=-1).reshape(nt * MAX_MIPS, 4)
    within = quad_budget_bytes is None or len(texels) * 16 <= quad_budget_bytes
    return TextureTable(texels=texels, mip_offset=mip_offset, mip_w=mip_w, mip_h=mip_h, mip_count=mip_count,
                        mip_rows=mip_rows.astype(np.int32),
                        texels_quad=np.concatenate(quads, axis=0) if within else None)


def to_device(table: TextureTable, device) -> TextureTable:
    """The table's arrays as tensors on `device` (None stays None)."""
    return TextureTable(**{
        f.name: None if getattr(table, f.name) is None
        else torch.from_numpy(np.ascontiguousarray(getattr(table, f.name))).to(device)
        for f in dataclasses.fields(TextureTable)
    })


def _unorm(t: torch.Tensor) -> torch.Tensor:
    """u8 -> f32 in [0, 1] as one IEEE division, like the reference's
    x / 255.0 (a tensor / scalar division on the GPU multiplies by the
    reciprocal)."""
    f = t.to(torch.float32)
    return f / torch.full_like(f, 255.0)


def sample(table: TextureTable, tex_id, uv, mip, *, bilinear: bool = True, meta=None):
    """Sample per pixel: tex_id i32 (0 = white), uv f32 [...,2] (repeat
    wrap), mip i32.  Returns f32 [...,4] in [0,1].

    `meta` = per-pixel (mip0_offset, mip0_w, mip0_h, mip_count) computes the
    mip's (offset, w, h) from floor-halving chains laid out consecutively,
    without the mip_rows gather; valid while pool offsets are f32-exact
    (< 2^24 texels; callers gate on that)."""
    tid = torch.clamp(tex_id, 0, table.mip_count.shape[0] - 1)
    m = torch.clamp(mip, 0, MAX_MIPS - 1)
    if meta is not None:
        off0, w0, h0, cnt = meta
        m = torch.minimum(m, torch.clamp_min(cnt - 1, 0))
        w = torch.clamp_min(w0 >> m, 1)
        h = torch.clamp_min(h0 >> m, 1)
        off = off0
        for k in range(MAX_MIPS - 1):
            off = off + torch.where(m > k, torch.clamp_min(w0 >> k, 1) * torch.clamp_min(h0 >> k, 1), 0)
    else:
        row = table.mip_rows[(tid * MAX_MIPS + m).to(torch.int64)]
        off, w, h = row[..., 0], row[..., 1], row[..., 2]
    wf, hf = w.to(torch.float32), h.to(torch.float32)

    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])

    def fetch(xi, yi):
        x = torch.remainder(xi, w)
        y = torch.remainder(yi, h)
        return _unorm(table.texels[(off + y * w + x).to(torch.int64)])

    if not bilinear:
        x0 = torch.minimum(torch.clamp_min((u * wf).to(torch.int32), 0), w - 1)
        y0 = torch.minimum(torch.clamp_min((v * hf).to(torch.int32), 0), h - 1)
        return fetch(x0, y0)

    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    if table.texels_quad is not None:
        q = _unorm(table.texels_quad[(off + torch.remainder(y0, h) * w + torch.remainder(x0, w)).to(torch.int64)])
        top = q[..., 0:4] * (1 - fx) + q[..., 4:8] * fx
        bot = q[..., 8:12] * (1 - fx) + q[..., 12:16] * fx
        return top * (1 - fy) + bot * fy
    top = fetch(x0, y0) * (1 - fx) + fetch(x0 + 1, y0) * fx
    bot = fetch(x0, y0 + 1) * (1 - fx) + fetch(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def select_mip_from_area(duv, area):
    """Mip level from the uv-to-pixel ratio and the texture's mip-0 texel
    area (w*h)."""
    ratio = duv * area
    return torch.clamp(0.5 * torch.log2(torch.clamp_min(ratio, 1.0)), 0, MAX_MIPS - 1).to(torch.int32)
