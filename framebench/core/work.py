"""Operations and bytes of the frame's setup and raster work, and the peaks.

A frozen copy of chip_smoke.py's arithmetic (`setup_work`, `raster_work`,
`bound`, the H100 SXM data-sheet peaks), counted from a captured frame's
inputs to each call: the same whatever kernel does the work.

What the counts assume (so that a later change of the program cannot make
them stale without this file saying so):
- setup: per live cluster its cluster row (6 words) and transform (32
  bytes); per distinct meshlet its 96 triangle rows of 3 ids, 64 vertex
  rows of 8 f32 and 64 vertex ids, and with opacity masks the 8 x 96 mask
  words of each distinct meshlet of a post class; per written triangle its
  56-float record, box (4 words) and flat index; SETUP_OPS f32 operations
  per live triangle slot (three corner transforms and snaps, edges, depth
  plane, bounds).
- raster: the tile starts, the pair list, the staged columns of each
  referenced record (13, 27 with masks), the carried and written depth and
  ids (16 bytes a pixel); RASTER_OPS per (pair, pixel) for the pixels of the
  pair's tile inside the triangle's box, and with masks MASK_OPS per
  covered pixel of a masked record (its screen area, at most its box).
- Every input byte is read once and every output byte written once.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM, HBM3, data sheet (700 W)
F32_OPS_S = 67e12  # f32 outside the tensor cores, data sheet
SETUP_OPS, RASTER_OPS, MASK_OPS = 420, 28, 34
REC_BYTES = 56 * 4
TILE_W, TILE_H = 128, 8


def bound_ms(nbytes: float, ops: float) -> float:
    """The least milliseconds the card could take: the larger of bytes over
    the HBM rate and operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3


def setup_work(tc, out, alpha: bool) -> tuple[float, float]:
    """(bytes, operations) of one setup call."""
    k = int(tc["count"][0])
    mi, post = tc["mi"][:k], tc["post_pass"][:k]
    nbytes = k * (4 * 6 + 32) + int(torch.unique(mi).numel()) * (96 * 3 * 4 + 64 * 8 * 4 + 64 * 4)
    if alpha:
        nbytes += int(torch.unique(mi[post > 0]).numel()) * 8 * 96 * 4
    nbytes += int(out["count"]) * (REC_BYTES + 4 * 4 + 4)
    return nbytes, SETUP_OPS * float(tc["tri_count"][:k].sum())


def raster_work(args, alpha: bool, H: int, W: int, tiles_x: int, band_row0: int = 0,
                grid_h: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of one raster call on an H x W target (a band of
    H rows band_row0 tile rows down a grid_h-row grid)."""
    ts, pt, rec = args[:3]
    p = int(ts[-1])
    ids = torch.unique(pt[:p].long())
    nbytes = ts.numel() * 4 + p * 4 + ids.numel() * (27 if alpha else 13) * 4 + H * W * 16
    # the box: x0/x1 in cols 12/14, y1 in col 15; col 13 holds the id, so y0
    # is the floor of the corners' smallest y (cols 17/25/33), 0 when a
    # corner is behind the eye (w, cols 18/26/34)
    r = rec[:, [12, 14, 15, 17, 25, 33, 18, 26, 34]][pt[:p].long()].double()
    behind = r[:, 6:9].min(dim=1).values <= 1e-9
    y0 = torch.where(behind, 0.0, torch.floor(r[:, 3:6].min(dim=1).values))
    tile = torch.searchsorted(ts[1:].long(), torch.arange(p, device=ts.device), right=True)
    tx, ty = (tile % tiles_x) * TILE_W, (tile // tiles_x + band_row0) * TILE_H
    nx = torch.clamp(torch.minimum(r[:, 1], tx + TILE_W) - torch.maximum(r[:, 0], tx), min=0)
    ny = torch.clamp(torch.minimum(r[:, 2], ty + TILE_H) - torch.maximum(y0, ty), min=0)
    ops = RASTER_OPS * float((nx * ny).sum())
    if alpha:
        r = rec[ids]
        r = r[r[:, 54] > 0].double()
        area = 0.5 * ((r[:, 24] - r[:, 16]) * (r[:, 33] - r[:, 17]) - (r[:, 25] - r[:, 17]) * (r[:, 32] - r[:, 16]))
        sy = torch.clamp(r[:, [17, 25, 33]], 0, grid_h or H)
        box = (r[:, 14] - r[:, 12]) * (sy.max(dim=1).values - sy.min(dim=1).values)
        ops += MASK_OPS * float(torch.minimum(area.abs(), box).sum())
    return nbytes, ops


def frame_work(capture: dict, sun_capture: dict | None, width: int, height: int, sun_map: int | None) -> dict:
    """{"setup": (bytes, ops), "raster": (bytes, ops)} of a captured frame:
    every setup and raster call of its passes, and the sun band's raster
    call when the frame updated the sun map."""
    setup_b = setup_o = raster_b = raster_o = 0.0
    for (tc, _cap), out in zip(capture["setup"], capture["setup_out"]):
        b, o = setup_work(tc, out, "alpha" in tc)
        setup_b, setup_o = setup_b + b, setup_o + o
    for args, alpha in zip(capture["raster"], capture["raster_alpha_test"]):
        b, o = raster_work(args, alpha, height, width, width // TILE_W)
        raster_b, raster_o = raster_b + b, raster_o + o
    if sun_capture:
        args = sun_capture["raster"]
        band_h = args[5].shape[0]
        b, o = raster_work(args, sun_capture["alpha_test"], band_h, sun_map, sun_map // TILE_W,
                           band_row0=sun_capture["band_row0"] or 0, grid_h=sun_map)
        raster_b, raster_o = raster_b + b, raster_o + o
    return {"setup": (setup_b, setup_o), "raster": (raster_b, raster_o)}
