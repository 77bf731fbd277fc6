"""Tile rasterizer and attribute resolve (niagara_tpu/ops/raster_tile.py).

* `emit_pairs` (:98) -- (tile, triangle) pairs sorted by tile, with the
  reference's footprint classes, class capacities and drop/demand
  counters.  Plain torch, as the reference computes it outside Pallas.
* `rasterize_tiles` (:519) -- pair emission + the tile raster kernel
  (csrc/raster.cu, replacing the Pallas `_raster_kernel` in its opaque,
  `alpha_test` and `row_window` variants); `raster_plain` is its plain
  torch version.
* `shade_tiles` (:918) -- per-pixel attribute interpolation over the
  visibility buffer (csrc/shade.cu, replacing the Pallas `_shade_kernel`);
  `shade_plain` is its plain torch version.

The framebuffer stays [H, W] (the reference's band-major [n_tiles, 8, 128]
layout is a TPU lane artifact); tile t covers pixel rows (t // tiles_x) * 8
+ [0, 8) and columns (t % tiles_x) * 128 + [0, 128).  Fragment ids are a
record's compacted index (record col 13) + the pass's frag offset.
"""

from __future__ import annotations

import torch

from ..config import TILE_H, TILE_W

from .. import _build
from . import compact, cullmath
from .setup import REC

# pair-emission footprint classes, in tiles (raster_tile.py:69-71)
SMALL_TX, SMALL_TY = 2, 3
MIDA_TX, MIDA_TY = 5, 8
MID_TX, MID_TY = 15, 32
# the giant class's default budget (triangles past the midB footprint; each
# slot emits a pair for every tile): street-level scenes raise it
# (presets.scene_capacities)
GIANT_CAPACITY = 64

ATTR_CHANNELS = 13  # nx ny nz u v viewz draw mat post vid0 vid1 vid2 duv


def class_budgets(tri_slots: int, *, mid_capacity: int | None = None, small_capacity: int | None = None,
                  midb_capacity: int | None = None, giant_capacity: int = GIANT_CAPACITY,
                  tiny2_capacity: int | None = None) -> tuple:
    """The triangle budgets (tiny2, small, midA, midB, giant) of emit_pairs'
    classes for a setup of `tri_slots` triangles: each given one, else its
    default."""
    T = tri_slots
    return (max(T // 2, 256) if tiny2_capacity is None else tiny2_capacity,
            max(1 << 15, T // 8) if small_capacity is None else small_capacity,
            max(4096, T // 64) if mid_capacity is None else mid_capacity,
            max(512, T // 1024) if midb_capacity is None else midb_capacity,
            giant_capacity)


def emit_pairs(setup: dict, *, tiles_x: int, tiles_y: int, pair_capacity: int,
               mid_capacity: int | None = None, small_capacity: int | None = None,
               midb_capacity: int | None = None, giant_capacity: int = GIANT_CAPACITY,
               tiny2_capacity: int | None = None, row_window: tuple[int, int] | None = None) -> dict:
    """Tile-sorted (tile, tri) pairs.  Returns dict(pair_tri [P], tile_start
    [n_tiles+1], pair_count, dropped, drop_vec [6] -- class overflow per
    (tiny2, small, midA, midB, giant, sort truncation) --, demand_vec [6]
    -- live triangles per (tiny1, tiny2, small, midA, midB, giant) --,
    pair_demand -- the live pairs before pair_capacity clamps them).

    `row_window=(row0, n_rows)` keeps the pairs of the tile rows [row0,
    row0 + n_rows) of the tiles_x x tiles_y grid, numbered from the band's
    first tile (raster_tile.py:109-116, 233-242).  Emission runs on the
    full grid (footprint classes and the u32 key check see the whole map);
    live pairs outside the band count in drop_vec[5]."""
    n_tiles = tiles_x * tiles_y
    valid = setup["valid"]
    T = valid.shape[0]
    dev = valid.device
    tiny2_capacity, small_capacity, mid_capacity, midb_capacity, giant_capacity = class_budgets(
        T, mid_capacity=mid_capacity, small_capacity=small_capacity, midb_capacity=midb_capacity,
        giant_capacity=giant_capacity, tiny2_capacity=tiny2_capacity)
    tri_bits = max(T - 1, 1).bit_length()
    assert tri_bits + n_tiles.bit_length() <= 32, "packed pair key overflows u32"

    x0, y0, x1, y1 = (setup[k].to(torch.int64) for k in ("x0", "y0", "x1", "y1"))
    tx0 = x0 // TILE_W
    ty0 = y0 // TILE_H
    txs = (x1 - 1) // TILE_W - tx0 + 1
    tys = (y1 - 1) // TILE_H - ty0 + 1

    is_tiny = valid & (txs * tys <= 2)
    fits_small = (txs <= SMALL_TX) & (tys <= SMALL_TY)
    fits_mida = (txs <= MIDA_TX) & (tys <= MIDA_TY)
    fits_midb = (txs <= MID_TX) & (tys <= MID_TY)
    is_small = valid & ~is_tiny & fits_small
    is_mida = valid & ~is_tiny & ~fits_small & fits_mida
    is_midb = valid & ~is_tiny & ~fits_small & ~fits_mida & fits_midb
    is_giant = valid & ~is_tiny & ~fits_small & ~fits_mida & ~fits_midb

    def emit(tri_idx, sel, cap_x, cap_y):
        """Dense [N, cap_x*cap_y] footprint emission of triangles tri_idx."""
        s = torch.arange(cap_x * cap_y, device=dev)[None, :]
        sx, sy = s % cap_x, s // cap_x
        live = sel[:, None] & (sx < txs[tri_idx][:, None]) & (sy < tys[tri_idx][:, None])
        tile = (ty0[tri_idx][:, None] + sy) * tiles_x + (tx0[tri_idx][:, None] + sx)
        tile = torch.where(live, tile, n_tiles)
        return tile.reshape(-1), tri_idx[:, None].expand(tile.shape).reshape(-1)

    def emit_compacted(mask, cap, cap_x, cap_y):
        idx, n, over = compact.compact_mask_indices(mask, cap)
        tile, tri = emit(idx, torch.arange(cap, device=dev) < n, cap_x, cap_y)
        return tile, tri, over

    # tiny1: one slot per triangle; tiny2 (exactly two tiles): compacted
    is_tiny1 = is_tiny & (txs * tys == 1)
    tri_idx = torch.arange(T, device=dev)
    tile_1 = torch.where(is_tiny1, ty0 * tiles_x + tx0, n_tiles)
    is_tiny2 = is_tiny & ~is_tiny1
    idx2, n2, over2 = compact.compact_mask_indices(is_tiny2, tiny2_capacity)
    sel2 = (torch.arange(idx2.shape[0], device=dev) < n2)[:, None]
    s2 = torch.arange(2, device=dev)[None, :]
    dx2 = torch.where(txs[idx2][:, None] == 2, s2, 0)
    dy2 = torch.where(tys[idx2][:, None] == 2, s2, 0)
    tile_2 = torch.where(sel2, (ty0[idx2][:, None] + dy2) * tiles_x + tx0[idx2][:, None] + dx2, n_tiles)
    tri_2 = idx2[:, None].expand(tile_2.shape)

    tile_s, tri_s, over_s = emit_compacted(is_small, small_capacity, SMALL_TX, SMALL_TY)
    tile_a, tri_a, over_a = emit_compacted(is_mida, mid_capacity, MIDA_TX, MIDA_TY)
    tile_b, tri_b, over_b = emit_compacted(is_midb, midb_capacity, MID_TX, MID_TY)
    tile_g, tri_g, over_g = emit_compacted(is_giant, giant_capacity, tiles_x, tiles_y)

    tiles_all = torch.cat([tile_1, tile_2.reshape(-1), tile_s, tile_a, tile_b, tile_g])
    tris_all = torch.cat([tri_idx, tri_2.reshape(-1), tri_s, tri_a, tri_b, tri_g])

    out_of_window = 0
    if row_window is not None:
        base, band = row_window[0] * tiles_x, row_window[1] * tiles_x
        live_full = tiles_all < n_tiles
        in_band = live_full & (tiles_all >= base) & (tiles_all < base + band)
        out_of_window = (live_full & ~in_band).sum()
        tiles_all = torch.where(in_band, tiles_all - base, band)
        n_tiles = band

    # u32 keys (tile << tri_bits | tri) in int64; dead pairs (tile n_tiles)
    # sort to the end; the key order is total, so the result is unique
    packed = torch.sort((tiles_all << tri_bits) | tris_all).values[:pair_capacity]
    pair_count = (tiles_all < n_tiles).sum()
    trunc = torch.clamp_min(pair_count - pair_capacity, 0) + out_of_window
    drop_vec = torch.stack([over2, over_s, over_a, over_b, over_g, trunc])
    demand_vec = torch.stack([m.sum() for m in (is_tiny1, is_tiny2, is_small, is_mida, is_midb, is_giant)])
    bounds = torch.arange(n_tiles + 1, device=dev) << tri_bits
    return dict(
        pair_tri=packed & ((1 << tri_bits) - 1),
        tile_start=torch.searchsorted(packed, bounds, side="left"),
        pair_count=torch.clamp_max(pair_count, pair_capacity),
        pair_demand=pair_count,
        dropped=drop_vec.sum(),
        drop_vec=drop_vec,
        demand_vec=demand_vec,
    )


def rasterize_tiles(setup: dict, depth, vis, *, tiles_x: int, tiles_y: int, pair_capacity: int,
                    frag_offset: int = 0, class_caps: tuple | None = None, alpha_test: bool = False,
                    row_window: tuple[int, int] | None = None, giant_capacity: int = GIANT_CAPACITY):
    """Rasterize set-up triangles onto depth/vis [H, W].  `class_caps` =
    (tiny2, small, midA, midB) pair-class budgets or None for emit_pairs'
    defaults, `giant_capacity` the giant class's; `alpha_test` runs the
    kernel's alpha variant (records with an opacity mask, cols 48-55,
    discard the pixels of clear mask cells).
    `row_window=(row0, n_rows)` renders only those tile rows of the
    tiles_x x tiles_y grid (raster_tile.py:519-547): depth/vis are then the
    band's [n_rows * 8, W] rows, and coverage is computed at full-grid
    pixel rows, so the band equals the matching rows of a full render.
    Returns (depth, vis, stats) with stats = emit_pairs' counters +
    `stream`, the record stream `shade_tiles` resolves attributes from, +
    `budgets`, the class budgets (class_budgets) and pair_capacity: what
    demand_vec[1:] and pair_demand are held to."""
    cc = dict(zip(("tiny2_capacity", "small_capacity", "mid_capacity", "midb_capacity"), class_caps or ()))
    pairs = emit_pairs(setup, tiles_x=tiles_x, tiles_y=tiles_y, pair_capacity=pair_capacity, row_window=row_window,
                       giant_capacity=giant_capacity, **cc)
    budgets = class_budgets(setup["valid"].shape[0], giant_capacity=giant_capacity, **cc) + (pair_capacity,)
    args = (pairs["tile_start"], pairs["pair_tri"], setup["rec"], frag_offset, depth, vis, tiles_x)
    raster = raster_plain if depth.device.type == "cpu" else raster_cuda
    depth, vis = raster(*args, alpha_test=alpha_test, band_row0=row_window[0] if row_window else None)
    stream = dict(rec=setup["rec"], frag_off=frag_offset, count=setup["count"])
    return depth, vis, dict(pairs, stream=stream, budgets=budgets)


def count_pairs(stages, name: str, stats: dict) -> None:
    """A rasterize_tiles pass's pair demand on `stages` (a
    utils.profiling.StageTimer, or None): "<name> pair classes", the
    triangles of the tiny2, small, midA, midB and giant classes against
    their budgets, and "<name> pairs", the live pairs against
    pair_capacity."""
    if stages is not None:
        stages.count(f"{name} pair classes", stats["demand_vec"][1:], stats["budgets"][:5])
        stages.count(f"{name} pairs", stats["pair_demand"], stats["budgets"][5])


def raster_cuda(tile_start, pair_tri, rec, frag_offset, depth, vis, tiles_x, alpha_test=False, band_row0=None):
    """The tile raster kernel (csrc/raster.cu), its alpha_test variant on
    request: raster_plain's contract.  A launch given a band start (the
    row_window variant, even a band from row 0) counts under its own name,
    `raster_window` / `raster_alpha_window`."""
    name = ("raster_alpha" if alpha_test else "raster") + ("" if band_row0 is None else "_window")
    _build.require_cuda(depth, name)
    H, W = depth.shape
    _build.expect(depth, torch.float32, (H, W), "raster depth")
    _build.expect(vis, torch.int32, (H, W), "raster vis")
    _build.expect(rec, torch.float32, (REC,), "raster records")
    if W != tiles_x * TILE_W or H % TILE_H or tile_start.shape[0] - 1 != tiles_x * (H // TILE_H):
        raise ValueError(f"raster: {H}x{W} framebuffer does not match {tile_start.shape[0] - 1} tiles")
    lib = _build.lib()
    ts = tile_start.to(torch.int64).contiguous()
    pt = pair_tri.to(torch.int64).contiguous()
    depth_in, vis_in = depth.contiguous(), vis.contiguous()
    depth_out, vis_out = torch.empty_like(depth_in), torch.empty_like(vis_in)
    rec = rec.contiguous()
    if rec.data_ptr() % 16:  # records are staged with 16-byte copies
        rec = rec.clone()
    # the persistent grid takes the tiles with most pairs first, from a counter
    order = torch.argsort(torch.diff(ts), descending=True).to(torch.int32)
    counter = torch.zeros(1, dtype=torch.int32, device=depth.device)
    rc = lib.raster_launch(ts.data_ptr(), order.data_ptr(), pt.data_ptr(), rec.data_ptr(), int(frag_offset),
                           depth_in.data_ptr(), vis_in.data_ptr(), depth_out.data_ptr(), vis_out.data_ptr(), W,
                           tiles_x, ts.shape[0] - 1, int(band_row0 or 0), int(alpha_test), counter.data_ptr(),
                           _build.stream_ptr(depth))
    _build.LAUNCHES[name] += 1
    _build.check(rc, name)
    return depth_out, vis_out


def _edge(r, k, fx, fy):
    return r[:, k : k + 1] * fx + r[:, k + 1 : k + 2] * fy + r[:, k + 2 : k + 3]


def mask_bit_float(half, bb):
    """The reference's f32 mask-bit extract (raster_tile.py:466-467):
    floor(half * 2^-(bb mod 16)) mod 2, as 0.0 / 1.0 (NaN for a NaN cell)."""
    t = torch.floor(half * torch.exp2(-torch.remainder(bb, 16.0)))
    return t - 2.0 * torch.floor(t * 0.5)


def _alpha_pass(r, e0, e1, e2):
    """Per (record, pixel): False where the record's opacity mask (cols
    48-55, idu = col 54 > 0) has the pixel's uv cell clear
    (raster_tile.py:450-468, the same ops in the same order)."""
    def c(k):
        return r[:, k : k + 1]

    wsum = e0 + e1 + e2
    inv = torch.where(torch.abs(wsum) < 1e-20, 0.0, cullmath.rdiv(1.0, wsum))
    u = (e1 * c(22) + e2 * c(30) + e0 * c(38)) * inv
    v = (e1 * c(23) + e2 * c(31) + e0 * c(39)) * inv
    gx = torch.clamp(torch.floor((u - c(52)) * c(54)), 0.0, 7.0)
    gy = torch.clamp(torch.floor((v - c(53)) * c(55)), 0.0, 7.0)
    bb = gy * 8.0 + gx
    half = torch.where(bb < 16.0, c(48), torch.where(bb < 32.0, c(49), torch.where(bb < 48.0, c(50), c(51))))
    return (c(54) <= 0.0) | (mask_bit_float(half, bb) > 0.5)


def raster_plain(tile_start, pair_tri, rec, frag_offset, depth, vis, tiles_x, alpha_test=False, band_row0=None):
    """Plain torch tile raster: every pair's record evaluated over its
    tile's 1024 pixel centers; per pixel the max reverse-Z covered depth
    wins, ties to the smallest fragment id, merged with the carried
    depth/vis under the same rule (raster_tile.py:416-492); `alpha_test`
    adds the opacity-mask test of masked records.  With `band_row0` the
    framebuffer is a band of tile rows starting at that full-grid row:
    coverage is tested at full-grid pixel rows (raster_tile.py:393), the
    result stored at the band's own rows."""
    H, W = depth.shape
    dev = depth.device
    n_tiles = tile_start.shape[0] - 1
    chunk = 1 << (16 if dev.type == "cuda" else 12)  # pairs per [chunk, 1024] evaluation
    lane = torch.arange(TILE_H * TILE_W, device=dev)
    ly, lx = lane // TILE_W, lane % TILE_W
    oy = (band_row0 or 0) * TILE_H
    # best (depth, -id) per pixel packed in one int64: f32 bits of a
    # positive depth order like the depth, so amax resolves both at once
    best = torch.zeros(H * W, dtype=torch.int64, device=dev)
    n_live = tile_start[-1]
    # the card evaluates the whole capacity, reading no count back; on the
    # CPU the read is free and the chunks past the live pairs cover nothing
    n_eval = pair_tri.shape[0] if dev.type == "cuda" else min(int(n_live), pair_tri.shape[0])
    for c0 in range(0, n_eval, chunk):
        p = torch.arange(c0, min(c0 + chunk, n_eval), device=dev)
        live = p < n_live
        t = torch.clamp_max(torch.searchsorted(tile_start[1:], p, right=True), n_tiles - 1)
        r = rec[pair_tri[p]] if alpha_test else rec[pair_tri[p]][:, :16]
        px = (t % tiles_x)[:, None] * TILE_W + lx
        py = (t // tiles_x)[:, None] * TILE_H + ly
        fx, fy = px.to(torch.float32) + 0.5, (py + oy).to(torch.float32) + 0.5
        cover = live[:, None]
        edges = []
        for k in (0, 3, 6):
            e = _edge(r, k, fx, fy)
            a, b = r[:, k : k + 1], r[:, k + 1 : k + 2]
            top_left = (a > 0.0) | ((a == 0.0) & (b > 0.0))
            cover = cover & ((e > 0.0) | (top_left & (e == 0.0)))
            edges.append(e)
        z = _edge(r, 9, fx, fy)
        cover = cover & (z > 0.0) & (z <= 1.0)
        if alpha_test:
            cover = cover & _alpha_pass(r, *edges)
        frag = r[:, 13].to(torch.int64) + frag_offset
        key = (z.view(torch.int32).to(torch.int64) << 32) | (0xFFFFFFFF - frag)[:, None]
        best.scatter_reduce_(0, (py * W + px).reshape(-1), torch.where(cover, key, 0).reshape(-1), "amax")
    zbest = (best >> 32).to(torch.int32).view(torch.float32).reshape(H, W)
    idbest = (0xFFFFFFFF - (best & 0xFFFFFFFF)).to(torch.int32).reshape(H, W)
    closer = zbest > depth
    tie = (zbest > 0.0) & (zbest == depth) & (idbest < vis)
    return torch.where(closer, zbest, depth), torch.where(closer | tie, idbest, vis)


def shade_tiles(streams: list[dict], vis) -> torch.Tensor:
    """Attribute planes [H, W, ATTR_CHANNELS] of every pixel's winning
    record, found in the one stream whose fragment-id range holds its vis
    (streams hold disjoint ranges); uncovered pixels are zero."""
    if vis.device.type == "cpu":
        return shade_plain(streams, vis)
    return shade_cuda(streams, vis)


def shade_cuda(streams, vis):
    """The shade kernel (csrc/shade.cu): shade_plain's contract for 1 to
    _build.SHADE_STREAMS streams on a framebuffer whose width is a multiple
    of 128."""
    if not 1 <= len(streams) <= _build.SHADE_STREAMS:
        raise ValueError(f"the shade kernel takes 1 to {_build.SHADE_STREAMS} record streams, got {len(streams)}")
    _build.require_cuda(vis, "shade")
    H, W = vis.shape
    _build.expect(vis, torch.int32, (H, W), "shade vis")
    if W % TILE_W:
        raise ValueError(f"shade: width {W} is not a multiple of {TILE_W}")
    arg = _build.ShadeStreams(n=len(streams))
    keep = []  # the tensors whose pointers the launch takes
    for i, s in enumerate(streams):
        rec = s["rec"]
        _build.expect(rec, torch.float32, (REC,), "shade records")
        rec = rec.contiguous()
        if rec.data_ptr() % 16:  # records are read with 16-byte loads
            rec = rec.clone()
        count = s["count"].to(torch.int64).reshape(1)
        _build.expect(count, torch.int64, (1,), "shade count")
        keep += [rec, count]
        arg.rec[i], arg.count[i], arg.off[i] = rec.data_ptr(), count.data_ptr(), int(s["frag_off"])
    v = vis.contiguous()
    attr = torch.empty((H, W, ATTR_CHANNELS), dtype=torch.float32, device=vis.device)
    if attr.data_ptr() % 16:  # the planes are written with 16-byte stores
        raise RuntimeError("shade: attribute planes not 16-byte aligned")
    rc = _build.lib().shade_launch(v.data_ptr(), W, H, arg, attr.data_ptr(), _build.stream_ptr(vis))
    _build.LAUNCHES["shade"] += 1
    _build.check(rc, "shade")
    return attr


def shade_plain(streams: list[dict], vis) -> torch.Tensor:
    """Plain torch shade: gather each pixel's winning record and
    interpolate with perspective-correct Olano-Greer weights
    (raster_tile.py:861-892)."""
    H, W = vis.shape
    dev = vis.device
    n = torch.arange(H * W, device=dev)
    fx = (n % W).to(torch.float32) + 0.5
    fy = (n // W).to(torch.float32) + 0.5
    v = vis.reshape(-1).to(torch.int64)
    attr = torch.zeros((H * W, ATTR_CHANNELS), dtype=torch.float32, device=dev)
    for s in streams:
        local = v - s["frag_off"]
        hit = (local >= 0) & (local < s["count"])
        r = s["rec"][torch.where(hit, local, 0)]

        def c(k):
            return r[:, k]

        e0 = c(0) * fx + c(1) * fy + c(2)
        e1 = c(3) * fx + c(4) * fy + c(5)
        e2 = c(6) * fx + c(7) * fy + c(8)
        wsum = e0 + e1 + e2
        inv = torch.where(torch.abs(wsum) < 1e-20, 0.0, cullmath.rdiv(1.0, wsum))
        pw0, pw1, pw2 = e1 * inv, e2 * inv, e0 * inv

        def interp(o):
            return pw0 * c(16 + o) + pw1 * c(24 + o) + pw2 * c(32 + o)

        uv_area = torch.abs((c(30) - c(22)) * (c(39) - c(23)) - (c(31) - c(23)) * (c(38) - c(22)))
        px_area = torch.abs((c(24) - c(16)) * (c(33) - c(17)) - (c(25) - c(17)) * (c(32) - c(16)))
        duv = uv_area / torch.clamp_min(px_area, 1e-6)
        vals = torch.stack([interp(3), interp(4), interp(5), interp(6), interp(7), interp(2),
                            c(43), c(44), c(45), c(40), c(41), c(42), duv], dim=-1)
        attr = torch.where(hit[:, None], vals, attr)
    return attr.reshape(H, W, ATTR_CHANNELS)
