"""Rasterized sun shadow map (niagara_tpu/ops/sunmap.py).

The scene rendered from the sun through the frame's own machinery into an
orthographic reverse-depth map, resolved per pixel by a 2x2 PCF depth
compare.  `sun_cull` / `sun_cluster_cull` are box tests in sun space,
commands come from the legacy `cull.build_task_commands`, `transform_sun`
puts the corners in map pixels with w == 1, `raster.compact_setup` sets
them up, and the tile raster kernel (csrc/raster.cu) rasterizes them --
with its alpha_test variant when the scene has opacity masks, and on a
band of tile rows (the row_window variant) for the per-frame update of an
animated tail.  The map is the port's [H, W] framebuffer layout: a band of
tile rows is the image's rows [row0 * 8, (row0 + n_rows) * 8).

Sun frames (`fit_sun`) hold tensors on the card unless the caller passes
another device (the CPU tests pass "cpu"); the fits and
`dirty_tile_rows` run on the host in numpy, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..config import TASK_WGSIZE, TILE_H, TILE_W
from ..utils.profiling import span
from . import compact, cull, cullmath, raster, raster_tile, shadow


def fit_sun(sun_direction, scene_min, scene_max, device="cuda") -> dict:
    """Orthographic sun frame fit to a world AABB (sunmap.py:31): rows
    [3,3] (world -> sun basis: u, v along the map, w toward the scene),
    lo/hi [3] extents in that basis.  Computed on the host in numpy; the
    tensors go to `device`, the card unless the caller names another."""
    L = -np.asarray(sun_direction, np.float32)
    L = L / np.linalg.norm(L)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(L @ up)) > 0.99:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    u = np.cross(up, L)
    u /= np.linalg.norm(u)
    v = np.cross(L, u)
    rows = np.stack([u, v, L], axis=0).astype(np.float32)
    mn = np.asarray(scene_min, np.float32)
    mx = np.asarray(scene_max, np.float32)
    corners = np.array(
        [[mn[0] if sx else mx[0], mn[1] if sy else mx[1], mn[2] if sz else mx[2]]
         for sx in (0, 1) for sy in (0, 1) for sz in (0, 1)], np.float32)
    sc = corners @ rows.T
    lo = sc.min(axis=0) - 1e-3
    hi = sc.max(axis=0) + 1e-3
    return {k: torch.tensor(np.asarray(a, np.float32), device=device) for k, a in (("rows", rows), ("lo", lo), ("hi", hi))}


def fit_sun_to_draws(sun_direction, draws, margin: float = 8.0, device="cuda") -> dict:
    """Sun frame fit to every draw position plus `margin` for the meshes'
    radii (sunmap.py:64)."""
    p = np.asarray(draws.position, np.float32)
    return fit_sun(sun_direction, p.min(axis=0) - margin, p.max(axis=0) + margin, device=device)


def map_texel_world(sf: dict, map_w: int, map_h: int) -> float:
    """World size of one map texel, the larger of its two sides, as the
    reference computes it in f32 (sunmap.py:285-286)."""
    ext = (sf["hi"] - sf["lo"]).cpu().numpy()
    return float(max(ext[0] / map_w, ext[1] / map_h))


def _to_sun(sf, p):
    """World [..., 3] -> sun-basis coordinates, row by row."""
    r = sf["rows"]
    return torch.stack([p[..., 0] * r[i, 0] + p[..., 1] * r[i, 1] + p[..., 2] * r[i, 2] for i in range(3)], dim=-1)


def _in_box(sf, cs, radius):
    return ((cs + radius[..., None] >= sf["lo"]) & (cs - radius[..., None] <= sf["hi"])).all(dim=-1)


def sun_cull(scene, sf, camera_position=None, lod_target=None, lod_enabled: int = 1, lod_bias: float = 4.0,
             texel_world: float | None = None, draw_range=None):
    """Per-draw cull for the sun map (sunmap.py:71-115): the draw's sphere
    against the sun box; transmission draws (class 2) cast no shadow; only
    ids in `draw_range` when given.  LOD: with `texel_world` the coarsest
    LOD whose error stays under one texel (camera-independent, for a cached
    map), else the main camera's rule coarsened by `lod_bias`.  Returns
    (emit [D] bool, lod [D] int64)."""
    row = scene.draw_mesh_row
    center = cullmath.rotate_quat(row[:, 0:3], scene.draw_orientation) * scene.draw_scale[:, None] + scene.draw_position
    radius = row[:, 3] * scene.draw_scale
    inside = _in_box(sf, _to_sun(sf, center), radius) & (scene.draw_post_pass != 2)
    if draw_range is not None:
        d = torch.arange(center.shape[0], device=center.device)
        inside = inside & (d >= draw_range[0]) & (d < draw_range[1])
    if texel_world is not None:
        threshold = cullmath.rdiv(texel_world, scene.draw_scale)
    else:
        cam = [float(c) for c in camera_position]
        dc = torch.stack([center[:, i] - cam[i] for i in range(3)], dim=-1)
        dist = torch.clamp_min(torch.sqrt(cullmath.dot3(dc, dc)) - radius, 0.0)
        threshold = dist * float(lod_target) * lod_bias / scene.draw_scale
    errors = row[:, 5:]
    idxs = torch.arange(errors.shape[1], device=errors.device)[None, :]
    passes = (errors < threshold[:, None]) & (idxs < row[:, 4].to(torch.int64)[:, None]) & (idxs > 0)
    lod = torch.where(passes, idxs, 0).amax(dim=1)
    if lod_enabled != 1:
        lod = torch.zeros_like(lod)
    return inside, lod


def sun_cluster_cull(scene, sf, cmds: cull.TaskCommands, cluster_capacity: int):
    """Per-meshlet sun-box cull over the commands' [C, 64] lanes, survivors
    compacted in (command, lane) order (sunmap.py:118-147).  Meshlet
    centres and radii are rounded through f16, as the reference reads them
    from its f16 cull blocks.  Returns (command [cap], lane [cap], count,
    overflow)."""
    lanes = torch.arange(TASK_WGSIZE, device=cmds.draw_id.device)[None, :]
    valid = lanes < cmds.task_count[:, None]
    xf = scene.draw_xform_row[cmds.draw_id]
    scale = xf[:, None, 3]
    mi = torch.clamp(cmds.task_offset[:, None] + lanes, 0, scene.meshlet_cull_row.shape[0] - 1)
    crow = scene.meshlet_cull_row[mi][..., :4].to(torch.float16).to(torch.float32)
    world = cullmath.rotate_quat(crow[..., 0:3], xf[:, None, 4:8]) * scale[..., None] + xf[:, None, 0:3]
    emit = valid & _in_box(sf, _to_sun(sf, world), crow[..., 3] * scale)
    idx, count, over = compact.compact_mask_indices(emit.reshape(-1), cluster_capacity)
    return idx // TASK_WGSIZE, idx % TASK_WGSIZE, count, over


def transform_sun(scene, sf, ccmd, clane, ccount, cmds: cull.TaskCommands, map_w: int, map_h: int) -> dict:
    """Cluster corners into sun-map pixel space for raster.compact_setup
    (sunmap.py:150-209): hx/hy in map pixels with w == 1 (orthographic, no
    subpixel snap), zw = 1 - 0.998 * (sun depth in [0, 1]) (1 nearest the
    sun).  With opacity masks it adds the corner uvs and the mask table
    (indexed by `mi`, as transform_meta_direct gives it)."""
    K = ccmd.shape[0]
    dev = ccmd.device
    live = torch.arange(K, device=dev) < ccount
    draw_id = cmds.draw_id[ccmd]
    mi = torch.clamp(cmds.task_offset[ccmd] + clane, 0, scene.meshlet_vertices.shape[0] - 1)
    tri_count = scene.meshlet_triangle_count[mi]
    vdata = scene.meshlet_vdata[mi]  # [K, 64, 8]
    xf = scene.draw_xform_row[draw_id]
    world = cullmath.rotate_quat(vdata[..., 0:3], xf[:, None, 4:8]) * xf[:, None, None, 3] + xf[:, None, 0:3]
    sc = _to_sun(sf, world)
    lo, ext = sf["lo"], sf["hi"] - sf["lo"]
    d01 = (sc[..., 2] - lo[2]) / ext[2]
    out = dict(
        tri_valid=live[:, None] & (torch.arange(scene.meshlet_tris.shape[1], device=dev)[None, :] < tri_count[:, None]),
        vid=scene.meshlet_vertices[mi],
        hx=(sc[..., 0] - lo[0]) / ext[0] * map_w,
        hy=(sc[..., 1] - lo[1]) / ext[1] * map_h,
        zw=1.0 - 0.998 * d01,
        viewz=torch.ones_like(d01),
        tri=scene.meshlet_tris[mi],
        draw_id=draw_id,
        mi=mi,
        count=torch.reshape(ccount, (1,)),
        post_pass=scene.draw_post_pass[draw_id],
    )
    if scene.has_alpha_masks:
        out["alpha"] = scene.meshlet_alpha
        out["uv"] = vdata[..., 6:8]
    return out


def render_sun_map(scene, sf, *, camera_position=None, lod_target=None, lod_enabled: int = 1,
                   map_w: int = 2048, map_h: int = 2048, cmd_capacity: int = 1 << 16,
                   cluster_capacity: int = 1 << 16, tri_capacity: int = 1 << 19, pair_capacity: int = 1 << 20,
                   lod_bias: float = 4.0, texel_world: float | None = None, draw_range=None, depth=None,
                   row_window: tuple[int, int] | None = None, capture: dict | None = None, stages=None):
    """Depth-only render of the scene (or the draws in `draw_range`) from
    the sun (sunmap.py:212-259).  `depth` carries an earlier batch's map
    (reverse depth merges by max); `row_window=(row0, n_rows)` renders only
    that band of tile rows, `depth` then being the band's rows, and the
    band equals the matching rows of a full render.  A `capture` dict
    receives the raster kernel's inputs and the pass's counts.  Its spans
    (utils.profiling.span) are "sun cull" (draws, commands, clusters),
    "sun setup" (transform, compact_setup) and "sun raster" (pair
    emission, sort, raster); `stages` (a StageTimer) gets their
    boundaries and the pass's pair demand ("sun", raster_tile.count_pairs).
    Returns (map [band rows, map_w], drop count)."""
    with span(stages, "sun cull"):
        emit, lod = sun_cull(scene, sf, camera_position, lod_target, lod_enabled, lod_bias=lod_bias,
                             texel_world=texel_world, draw_range=draw_range)
        dvb = torch.ones(scene.num_draws, dtype=torch.int32, device=emit.device)
        cmds = cull.build_task_commands(scene, emit, lod, dvb, capacity=cmd_capacity)
        ccmd, clane, ccount, cover = sun_cluster_cull(scene, sf, cmds, cluster_capacity)
    with span(stages, "sun setup"):
        tc = transform_sun(scene, sf, ccmd, clane, ccount, cmds, map_w, map_h)
        st = raster.compact_setup(tc, map_w, map_h, 1e-3, tri_capacity)

    with span(stages, "sun raster"):
        tiles_x, tiles_y = map_w // TILE_W, map_h // TILE_H
        band_h = (row_window[1] if row_window is not None else tiles_y) * TILE_H
        if depth is None:
            depth = torch.zeros((band_h, map_w), dtype=torch.float32, device=emit.device)
        vis = torch.full((band_h, map_w), raster.INVALID_FRAG, dtype=torch.int32, device=emit.device)
        carry = depth
        # alpha-test casters against their masks, so cutouts cast holed shadows
        alpha = bool(scene.has_alpha_masks)
        depth, _, rst = raster_tile.rasterize_tiles(st, depth, vis, tiles_x=tiles_x, tiles_y=tiles_y,
                                                    pair_capacity=pair_capacity, alpha_test=alpha,
                                                    row_window=row_window)
    raster_tile.count_pairs(stages, "sun", rst)
    if capture is not None:
        capture.update(raster=(rst["tile_start"], rst["pair_tri"], st["rec"], 0, carry, vis), alpha_test=alpha,
                       band_row0=None if row_window is None else row_window[0], draws=cmds.count,
                       clusters=ccount, tris=st["count"], pairs=rst["pair_count"], drop_vec=rst["drop_vec"])
    return depth, cmds.dropped + cover + st["dropped"] + rst["dropped"]


def build_static_sun_map(scene, sf, *, map_w: int = 2048, map_h: int = 2048, batch: int = 1 << 14,
                         texel_world: float | None = None, num_draws: int | None = None, **caps):
    """The cached map of a static scene (sunmap.py:265-311): draw ids [0,
    num_draws) in batches of `batch`, each rendered onto the map so far
    with the texel LOD (camera-independent).  The map is the cached input
    of update_sun_map.  Returns (map [map_h, map_w], total drop count --
    0 for a complete map)."""
    if texel_world is None:
        texel_world = map_texel_world(sf, map_w, map_h)
    D = scene.num_draws if num_draws is None else int(num_draws)
    depth, dropped = None, 0
    for b in range(-(-D // batch)):
        depth, drop_b = render_sun_map(scene, sf, map_w=map_w, map_h=map_h, texel_world=texel_world,
                                       draw_range=(b * batch, min((b + 1) * batch, D)), depth=depth, **caps)
        dropped = dropped + drop_b
    return depth, dropped


def update_sun_map(scene, sf, static_map, draw_range, *, map_w: int = 2048, map_h: int = 2048,
                   texel_world: float | None = None, row_window: tuple[int, int] | None = None, **kw):
    """Per-frame update of an animated scene (sunmap.py:314-352): the
    draws in `draw_range` (or all of `scene`, e.g. a slice_draws tail) at
    their current transforms, rendered onto the cached static map.  With
    `row_window` only that band of tile rows is rendered and returned; the
    static rows outside it are untouched.  Returns (map or band, drops)."""
    if texel_world is None:
        texel_world = map_texel_world(sf, map_w, map_h)
    if row_window is not None:
        static_map = static_map[row_window[0] * TILE_H:(row_window[0] + row_window[1]) * TILE_H]
    return render_sun_map(scene, sf, map_w=map_w, map_h=map_h, texel_world=texel_world, draw_range=draw_range,
                          depth=static_map, row_window=row_window, **kw)


def dirty_tile_rows(sf, positions, radius, map_h: int, *, margin: float = 0.0, pad_rows: int = 1):
    """Conservative tile-row window (row0, n_rows) covering world spheres
    plus `margin` (sunmap.py:355-377, host numpy)."""
    rows = sf["rows"].cpu().numpy()
    lo, hi = sf["lo"].cpu().numpy(), sf["hi"].cpu().numpy()
    p = np.asarray(positions.cpu() if torch.is_tensor(positions) else positions, np.float32)
    r = np.broadcast_to(np.asarray(radius.cpu() if torch.is_tensor(radius) else radius, np.float32),
                        (p.shape[0],)) + margin
    sy = p @ rows[1]
    scale = map_h / (hi[1] - lo[1])
    py0 = (sy - r - lo[1]) * scale
    py1 = (sy + r - lo[1]) * scale
    tiles_y = map_h // TILE_H
    r0 = max(int(np.floor(py0.min() / TILE_H)) - pad_rows, 0)
    r1 = min(max(int(np.ceil(py1.max() / TILE_H)) + pad_rows, r0 + 1), tiles_y)
    return r0, r1 - r0


def pack_sun_map(sun_map):
    """Row y * W + x holds the 2x2 PCF footprint [z(x,y), z(x+1,y),
    z(x,y+1), z(x+1,y+1)], edge-clamped (sunmap.py:410-421): one 16-byte
    row per resolve sample."""
    h, w = sun_map.shape
    zx = torch.cat([sun_map[:, 1:], sun_map[:, -1:]], dim=1)
    zy = torch.cat([sun_map[1:, :], sun_map[-1:, :]], dim=0)
    zxy = torch.cat([zx[1:, :], zx[-1:, :]], dim=0)
    return torch.stack([sun_map, zx, zy, zxy], dim=-1).reshape(h * w, 4)


def pack_band(packed_static, band_img, row0_px: int, map_h: int, row_above=None, row_below=None):
    """A cached pack_sun_map table with a band's quads spliced in
    (sunmap.py:380-407): band_img holds map rows [row0_px, row0_px + bh);
    the quads of rows [row0_px - 1, row0_px + bh) change, so `row_above` is
    the static row row0_px - 1 (None at the top) and `row_below` the static
    row row0_px + bh (None at the bottom).  Returns a new table, equal to
    pack_sun_map of the updated map.  In the span "pack_band" (the
    profiler's alone: the caller marks its own boundary)."""
    with span(None, "pack_band"):
        bh, w = band_img.shape
        above = row_above is not None and row0_px > 0
        parts = [row_above.reshape(1, w)] if above else []
        parts.append(band_img)
        if row0_px + bh < map_h:
            assert row_below is not None, "an interior band needs the static row below it"
            parts.append(row_below.reshape(1, w))
        n_q = (1 if above else 0) + bh
        start = (row0_px - (1 if above else 0)) * w
        out = packed_static.clone()
        out[start:start + n_q * w] = pack_sun_map(torch.cat(parts, dim=0))[: n_q * w]
    return out


def _sun_coords(sf, wpos, map_h: int, map_w: int, bias_texels: float):
    """Texel coordinates (px, py) of the PCF footprint, the receiver's
    reverse depth and the bias (sunmap.py:428-435)."""
    sc = _to_sun(sf, wpos)
    lo, ext = sf["lo"], sf["hi"] - sf["lo"]
    px = (sc[..., 0] - lo[0]) / ext[0] * map_w - 0.5
    py = (sc[..., 1] - lo[1]) / ext[1] * map_h - 0.5
    z_here = 1.0 - 0.998 * ((sc[..., 2] - lo[2]) / ext[2])
    bias = 0.998 * bias_texels * torch.maximum(cullmath.div(ext[0], map_w), cullmath.div(ext[1], map_h)) / ext[2]
    return px, py, z_here, bias


def _pcf(lit, fx, fy):
    return (lit[..., 0] * (1 - fx) * (1 - fy) + lit[..., 1] * fx * (1 - fy)
            + lit[..., 2] * (1 - fx) * fy + lit[..., 3] * fx * fy)


def sample_shadow_packed(packed, map_h: int, map_w: int, sf, wpos, *, bias_texels: float = 1.5):
    """Shadow term in [0, 1] at world positions [..., 3] from a
    pack_sun_map table, one row gather each (sunmap.py:424-452): a base
    texel off the map clamps to the border with its fractional weight
    zeroed, the same decisions as sample_shadow's clamped taps."""
    px, py, z_here, bias = _sun_coords(sf, wpos, map_h, map_w, bias_texels)
    x0, y0 = torch.floor(px).to(torch.int64), torch.floor(py).to(torch.int64)
    fx = torch.where(x0 < 0, 0.0, px - x0.to(torch.float32))
    fy = torch.where(y0 < 0, 0.0, py - y0.to(torch.float32))
    quad = packed[torch.clamp(y0, 0, map_h - 1) * map_w + torch.clamp(x0, 0, map_w - 1)]
    return _pcf(torch.where(quad <= (z_here + bias)[..., None], 1.0, 0.0), fx, fy)


def sample_shadow(sun_map, sf, wpos, *, bias_texels: float = 1.5):
    """Shadow term in [0, 1] at world positions [..., 3]: 2x2 PCF depth
    compare against the map, each tap clamped to it, the receiver biased
    by `bias_texels` texels toward the sun (sunmap.py:455-495).  The plain
    check of the packed resolve."""
    map_h, map_w = sun_map.shape
    px, py, z_here, bias = _sun_coords(sf, wpos, map_h, map_w, bias_texels)
    x0, y0 = torch.floor(px).to(torch.int64), torch.floor(py).to(torch.int64)
    fx, fy = px - x0.to(torch.float32), py - y0.to(torch.float32)
    taps = [sun_map[torch.clamp(y0 + dy, 0, map_h - 1), torch.clamp(x0 + dx, 0, map_w - 1)]
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1))]
    return _pcf(torch.where(torch.stack(taps, dim=-1) <= (z_here + bias)[..., None], 1.0, 0.0), fx, fy)


def shadow_map_pass(depth, sf, sun_map, *, inverse_view_projection, width: int, height: int,
                    bias_texels: float = 1.5, scale: int = 2, packed=None, map_shape=None, blur: bool = False,
                    znear: float = 0.1, stages=None):
    """Shadow term [height, width] from the camera's reverse-Z depth
    (sunmap.py:498-541): world positions reconstructed at 1/scale
    resolution, resolved against the packed table (`packed`, `map_shape`)
    or the map, 1 where nothing was drawn, optionally blurred
    (shadow.shadow_blur), then repeated up to full size.  CPU tensors take
    the plain twin (shadow_map_plain), CUDA tensors the kernel
    (shadow_resolve_cuda; without `packed` it packs the map first, so it
    resolves as the twin does from pack_sun_map's table).  `stages` (a
    StageTimer) gets the count "sun-map resolve texels": the 1/scale
    texels tested against the map (depth > 0) against all of them."""
    kw = dict(inverse_view_projection=inverse_view_projection, width=width, height=height, bias_texels=bias_texels,
              scale=scale, blur=blur, znear=znear)
    if depth.device.type == "cpu":
        term = shadow_map_plain(depth, sf, sun_map, packed=packed, map_shape=map_shape, **kw)
        if stages is not None:
            tested = tested_texels(depth, width, height, scale)
    else:
        if packed is None:
            packed, map_shape = pack_sun_map(sun_map), sun_map.shape
        elif map_shape is None:
            map_shape = sun_map.shape
        term, tested = shadow_resolve_cuda(depth, sf, packed, map_shape, **kw)
    if stages is not None:
        stages.count("sun-map resolve texels", tested, (height // scale) * (width // scale))
    return term


def tested_texels(depth, width: int, height: int, scale: int):
    """The texels of the 1/scale grid that the resolve tests against the
    map, those where something was drawn (depth > 0): a 0-d count."""
    return (depth[::scale, ::scale][:height // scale, :width // scale] > 0.0).sum()


def shadow_resolve_cuda(depth, sf, packed, map_shape, *, inverse_view_projection, width: int, height: int,
                        bias_texels: float = 1.5, scale: int = 2, blur: bool = False, znear: float = 0.1):
    """The resolve kernel (csrc/shadowmap.cu): shadow_map_plain's contract
    on the packed table in one launch (and the count's zeroing), plus the
    texels it tested against the map (an int32 [1] word the kernel sums
    into).  It allocates only its outputs and refuses inputs of another
    dtype, device or shape, or not contiguous.  Returns (term, tested)."""
    mh, mw = (int(v) for v in map_shape)
    sw, sh = width // scale, height // scale
    if scale < 1 or sw < 1 or sh < 1 or mh < 1 or mw < 1:
        raise ValueError(f"shadow_resolve: a {width}x{height} frame at 1/{scale} on a {mw}x{mh} map has no texel")
    inputs = ((depth, (height, width), "depth"), (packed, (mh * mw, 4), "packed"), (sf["rows"], (3, 3), "sun rows"),
              (sf["lo"], (3,), "sun lo"), (sf["hi"], (3,), "sun hi"))
    for t, shape, what in inputs:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"shadow_resolve {what}: expected a contiguous float32 {shape} tensor, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    _build.require_cuda(depth, "shadow_resolve")
    for t, _, what in inputs:
        if t.device != depth.device:
            raise ValueError(f"shadow_resolve {what}: on {t.device}, the depth on {depth.device}")
    if packed.data_ptr() % 16:  # rows are read with 16-byte loads
        raise ValueError("shadow_resolve packed: the table is not 16-byte aligned")
    out = torch.empty((sh * scale, sw * scale), dtype=torch.float32, device=depth.device)
    tested = torch.empty(1, dtype=torch.int32, device=depth.device)
    args = _build.ShadowResolveArgs(
        depth=depth.data_ptr(), packed=packed.data_ptr(), rows=sf["rows"].data_ptr(), lo=sf["lo"].data_ptr(),
        hi=sf["hi"].data_ptr(), out=out.data_ptr(), count=tested.data_ptr(),
        bias_scale=0.998 * bias_texels, znear=float(znear), width=width, height=height, scale=scale, sw=sw, sh=sh,
        map_w=mw, map_h=mh)
    args.ivp[:] = [float(x) for x in np.asarray(inverse_view_projection, dtype=np.float32).reshape(16)]
    # the blur's tap weights as torch rounds the Python scalars
    args.tap_w[:] = [float(np.exp2(-i * i / 50.0)) for i in range(1, _build.SHADOW_TAPS + 1)]
    rc = _build.lib().shadow_resolve_launch(args, int(blur), _build.stream_ptr(depth))
    _build.LAUNCHES["shadow_resolve"] += 1
    _build.check(rc, "shadow_resolve")
    return out, tested


def shadow_map_plain(depth, sf, sun_map, *, inverse_view_projection, width: int, height: int,
                     bias_texels: float = 1.5, scale: int = 2, packed=None, map_shape=None, blur: bool = False,
                     znear: float = 0.1):
    """Plain torch resolve: shadow_map_pass's contract (without the
    count), op by op as the kernel computes it from a packed table."""
    d_small, wpos = shadow.world_positions(depth, inverse_view_projection, width, height, scale)
    if packed is not None:
        mh, mw = map_shape if map_shape is not None else sun_map.shape
        term = sample_shadow_packed(packed, mh, mw, sf, wpos, bias_texels=bias_texels)
    else:
        term = sample_shadow(sun_map, sf, wpos, bias_texels=bias_texels)
    term = torch.where(d_small > 0.0, term, 1.0)
    if blur:
        term = shadow.shadow_blur(term, d_small, znear)
    if scale == 1:
        return term
    return term.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)[:height, :width]
