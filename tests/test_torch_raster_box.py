"""What the raster kernel (csrc/raster.cu) relies on: a pixel that
raster_plain's full-tile evaluation covers lies inside the record's clip
box -- the bounding box of the triangle its three edge equations bound,
each edge moved outward by the most its f32 evaluation over the tile can
be off, or the whole tile where the edges bound no finite triangle
(`clip_boxes`, the kernel's clip_box in float64) -- so the kernel may test
a record only on the pixels of its tile inside that box.

Checked for every pair of the small opaque frame, the small alpha frame
(post_passes=2, alpha_test in the late pass), the small sun map (a whole
map and a band), and for crafted records: a triangle crossing the camera
plane (a full-screen box), a nearly edge-on one, a one-pixel one, random
slivers, and a record of the 1920x1080 frame whose coverage lies outside
the setup's own box (cols 12-15 and y0): rounding of its edge
coefficients moves its tip 13 pixels past that box (ROADMAP.md, queue C),
which is why the kernel does not clip to it.  Plain torch only (no JAX):
tests/test_torch_kernels.py builds its crafted records with
`crafted_setup` on the card."""

import numpy as np
import pytest
import torch

from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.config import TILE_H, TILE_W
from niagara_tpu_torch.ops import raster, raster_tile, sunmap
from niagara_tpu_torch.render import camera, frame, presets, textures

W, H = 256, 128
ZNEAR = 0.1


def crafted_setup(corners, width, height, *, masks=None, uv=None, capacity=None, device="cpu"):
    """raster.compact_setup of one triangle per cluster: corners [N, 3, 4]
    (hx, hy, w, zw) in homogeneous pixel space.  With `masks` [N, 8] (the
    opacity-mask rows: 4 halves, u0, v0, 8/du, 8/dv) and `uv` [N, 3, 2]
    the records carry them (cols 48-55 and the corner uvs)."""
    c = torch.as_tensor(np.asarray(corners, np.float32), device=device)
    n = c.shape[0]
    pad = torch.zeros((n, 64, 4), dtype=torch.float32, device=device)
    pad[:, :3] = c
    tc = dict(tri=torch.arange(3, device=device).expand(n, 1, 3), hx=pad[..., 0], hy=pad[..., 1],
              viewz=pad[..., 2], zw=pad[..., 3], tri_valid=torch.ones((n, 1), dtype=torch.bool, device=device),
              vid=torch.arange(64, dtype=torch.int32, device=device).expand(n, 64),
              draw_id=torch.arange(n, device=device), mi=torch.arange(n, device=device),
              post_pass=torch.zeros(n, dtype=torch.int32, device=device),
              count=torch.tensor([n], device=device))
    if masks is not None:
        table = torch.zeros((n, 8, 128), dtype=torch.float32, device=device)
        table[:, :, 0] = torch.as_tensor(np.asarray(masks, np.float32), device=device)
        uvs = torch.zeros((n, 64, 2), dtype=torch.float32, device=device)
        uvs[:, :3] = torch.as_tensor(np.asarray(uv, np.float32), device=device)
        tc.update(alpha=table, uv=uvs)
    return raster.compact_setup(tc, width, height, ZNEAR, capacity or n)


def front_facing(hx, hy, w):
    """[N, 3] homogeneous corners -> [N, 3] index order with det > 0
    (setup's front test), swapping B and C where needed."""
    eBC = (w[:, 1] * hy[:, 2] - hy[:, 1] * w[:, 2], hx[:, 1] * w[:, 2] - w[:, 1] * hx[:, 2],
           hy[:, 1] * hx[:, 2] - hx[:, 1] * hy[:, 2])
    det = hx[:, 0] * eBC[0] + hy[:, 0] * eBC[1] + w[:, 0] * eBC[2]
    return np.where((det < 0)[:, None], [0, 2, 1], [0, 1, 2])


def screen_triangles(xy, zw):
    """Corners [N, 3, 4] of triangles given in pixels (w = 1), front-facing."""
    order = front_facing(xy[..., 0], xy[..., 1], np.ones(xy.shape[:2], np.float32))
    xy = np.take_along_axis(xy, order[..., None], axis=1)
    return np.concatenate([xy, np.ones(xy.shape[:2] + (1,)), zw[..., None]], axis=-1).astype(np.float32)


def view_triangles(pts, width, height):
    """Corners [N, 3, 4] of view-space triangles [N, 3, 3] (x, y, depth)
    through the setup's projection (p00 = p11 = 1, no snap), in both
    windings: setup keeps the front-facing one."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    safe = np.where(np.abs(z) < 1e-12, 1e-12, z)
    c = np.stack([(x * 0.5 + 0.5 * z) * width, (0.5 * z - y * 0.5) * height, z, ZNEAR / safe], axis=-1)
    return np.concatenate([c, c[:, [0, 2, 1]]]).astype(np.float32)


def clip_boxes(r, tx0, gty0):
    """[P, 4] (x0, x1, y0, y1) per pair: the pixels of the pair's tile (at
    column tx0, full-grid row gty0) that record row r's edge tests can pass
    -- csrc/raster.cu's clip_box, in float64."""
    a, b, c = (r[:, [k, k + 3, k + 6]].double() for k in range(3))
    xm, ym = (tx0 + TILE_W).double()[:, None], (gty0 + TILE_H).double()[:, None]
    c = c + (a.abs() * xm + b.abs() * ym + c.abs()) * 2.0**-21
    j = [1, 2, 0]
    s = a * b[:, j] - a[:, j] * b
    x = (b * c[:, j] - b[:, j] * c) / s
    y = (c * a[:, j] - c[:, j] * a) / s
    bounded = (((s > 0).all(dim=1) | (s < 0).all(dim=1)) & torch.isfinite(c).all(dim=1))[:, None]
    lo = torch.stack([tx0, tx0, gty0, gty0], dim=1).double()
    hi = lo + torch.tensor([TILE_W, TILE_W, TILE_H, TILE_H], dtype=torch.float64)
    box = torch.stack([torch.floor(x.min(dim=1).values - 0.5), torch.floor(x.max(dim=1).values - 0.5) + 1,
                       torch.floor(y.min(dim=1).values - 0.5), torch.floor(y.max(dim=1).values - 0.5) + 1], dim=1)
    box = torch.where(torch.isnan(box), lo, torch.minimum(torch.maximum(box, lo), hi))
    return torch.where(bounded, box, torch.cat([lo[:, :1], hi[:, 1:2], lo[:, 2:3], hi[:, 3:]], dim=1))


def coverage_outside(tile_start, pair_tri, rec, y0, tiles_x, alpha_test=False, band_row0=None):
    """(covered (pair, pixel) count, how many of them lie outside the clip
    box, how many outside the setup's box [x0, x1) x [y0, y1)):
    raster_plain's per-pair coverage over the whole tile, at full-grid
    pixel rows for a band."""
    n = int(tile_start[-1])
    lane = torch.arange(TILE_H * TILE_W)
    ly, lx = lane // TILE_W, lane % TILE_W
    covered = out_clip = out_setup = 0
    for c0 in range(0, n, 4096):
        p = torch.arange(c0, min(c0 + 4096, n))
        t = torch.searchsorted(tile_start[1:], p, right=True)
        idx = pair_tri[p].long()
        r = rec[idx]
        tx0, gty0 = (t % tiles_x) * TILE_W, (t // tiles_x + (band_row0 or 0)) * TILE_H
        px, gy = tx0[:, None] + lx, gty0[:, None] + ly
        fx, fy = px.to(torch.float32) + 0.5, gy.to(torch.float32) + 0.5
        cover = torch.ones(px.shape, dtype=torch.bool)
        edges = []
        for k in (0, 3, 6):
            e = raster_tile._edge(r, k, fx, fy)
            a, b = r[:, k : k + 1], r[:, k + 1 : k + 2]
            cover = cover & ((e > 0.0) | (((a > 0.0) | ((a == 0.0) & (b > 0.0))) & (e == 0.0)))
            edges.append(e)
        z = raster_tile._edge(r, 9, fx, fy)
        cover = cover & (z > 0.0) & (z <= 1.0)
        if alpha_test:
            cover = cover & raster_tile._alpha_pass(r, *edges)
        box = clip_boxes(r, tx0, gty0)
        clip = (px >= box[:, 0:1]) & (px < box[:, 1:2]) & (gy >= box[:, 2:3]) & (gy < box[:, 3:4])
        setup_box = ((px >= r[:, 12:13]) & (px < r[:, 14:15]) & (gy >= y0[idx][:, None].long())
                     & (gy < r[:, 15:16]))
        covered += int(cover.sum())
        out_clip += int((cover & ~clip).sum())
        out_setup += int((cover & ~setup_box).sum())
    return covered, out_clip, out_setup


def _pairs(st, width, height, row_window=None):
    tx, ty = width // TILE_W, height // TILE_H
    return raster_tile.emit_pairs(st, tiles_x=tx, tiles_y=ty, pair_capacity=1 << 17, row_window=row_window)


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    return cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))


def _frame_streams(geometry, alpha):
    """Each pass of the second small frame: (tile_start, pair_tri, rec, y0, alpha_test)."""
    if alpha:
        g, d, mats, masks, mips = cooker.small_alpha_scene(geometry)
        table = textures.build_texture_table(mips)
        sc = scene.from_numpy(scene.upload(g, d, mats, masks, texture_table=table), "cpu")
        tex = textures.to_device(table, "cpu")
    else:
        sc = scene.from_numpy(scene.upload(geometry, cooker.small_scene_draws(geometry.meshes.count)), "cpu")
        tex = None
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2 if alpha else 1, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    st = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, "cpu")
    cap = {}
    for _ in range(2):
        _, _, st, _ = frame.render_frame(sc, st, params, sp, cfg, textures=tex, capture=cap)
    return [(ts, pt, rec, out["y0"], a)
            for (ts, pt, rec, *_), out, a in zip(cap["raster"], cap["setup_out"], cap["raster_alpha_test"])]


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
def test_small_frame_coverage_inside_box(geometry, alpha):
    total = 0
    for ts, pt, rec, y0, alpha_test in _frame_streams(geometry, alpha):
        covered, outside, _ = coverage_outside(ts, pt, rec, y0, W // TILE_W, alpha_test=alpha_test)
        assert outside == 0, f"{outside} of {covered} covered pixels outside their clip box"
        total += covered
    assert total > 10_000


@pytest.mark.parametrize("window", [None, (7, 13)], ids=["map", "band"])
def test_small_sun_map_coverage_inside_box(geometry, window):
    g, d, mats, masks, mips = cooker.small_alpha_scene(geometry)
    sc = scene.from_numpy(scene.upload(g, d, mats, masks, texture_table=textures.build_texture_table(mips)), "cpu")
    _, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), frame.FrameConfig(width=W, height=H))
    sf = sunmap.fit_sun_to_draws(sp.sun_direction, d, device="cpu")
    m, cap = 256, {}
    band = None if window is None else torch.zeros((window[1] * TILE_H, m))
    sunmap.render_sun_map(sc, sf, map_w=m, map_h=m, texel_world=sunmap.map_texel_world(sf, m, m), cmd_capacity=256,
                          cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15, depth=band,
                          row_window=window, capture=cap)
    ts, pt, rec = cap["raster"][:3]
    covered, outside, _ = coverage_outside(ts, pt, rec, torch.zeros(rec.shape[0], dtype=torch.int32), m // TILE_W,
                                           alpha_test=cap["alpha_test"], band_row0=cap["band_row0"])
    assert outside == 0, f"{outside} of {covered} covered texels outside their clip box"
    assert covered > 1000


def _crafted(kind):
    rng = np.random.default_rng(7)
    if kind == "camera_plane":  # one corner behind the eye: the box is the whole screen
        return view_triangles(np.array([[[-0.4, -0.2, 2.0], [0.5, -0.1, 2.5], [0.1, 0.3, -0.5]]]), W, H)
    if kind == "edge_on":  # C just off the plane y = z / 20 of A, B and the eye: a 0.8-pixel sliver
        return view_triangles(np.array([[[-0.5, 0.1, 2.0], [0.5, 0.1, 2.0], [0.0, 0.25, 4.0]]]), W, H)
    if kind == "one_pixel":
        return screen_triangles(np.array([[[10.2, 20.3], [11.1, 20.4], [10.6, 21.2]]]), np.full((1, 3), 0.5))
    # random slivers: thin triangles at every angle, ~1000:1 and thinner
    n = 4000
    a = rng.uniform([0, 0], [W, H], (n, 2))
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.uniform(2, 200, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * length[:, None]
    off = np.stack([-np.sin(ang), np.cos(ang)], -1) * (length * 10.0 ** rng.uniform(-5, -2, n))[:, None]
    xy = np.stack([a, a + d, a + 0.5 * d + off], axis=1)
    return screen_triangles(xy, rng.uniform(0.05, 0.95, (n, 3)))


@pytest.mark.parametrize("kind", ["camera_plane", "edge_on", "one_pixel", "slivers"])
def test_crafted_coverage_inside_box(kind):
    st = crafted_setup(_crafted(kind), W, H)
    assert int(st["count"]) >= 1
    if kind == "camera_plane":
        assert (int(st["x0"][0]), int(st["y0"][0]), int(st["x1"][0]), int(st["y1"][0])) == (0, 0, W, H)
    pairs = _pairs(st, W, H)
    covered, outside, _ = coverage_outside(pairs["tile_start"], pairs["pair_tri"], st["rec"], st["y0"], W // TILE_W)
    assert outside == 0, f"{outside} of {covered} covered pixels outside their clip box"
    assert covered > 0


def test_rounded_edges_cover_outside_the_setup_box():
    """A record of the 1920x1080 opaque frame (cols 0-15, setup y0 997):
    its edge equations cover pixel (482, 996), 13 pixels left of and one
    row above its setup box [495, 507) x [997, 999) -- raster_plain and the
    kernel both draw it there, inside the record's clip box."""
    rec = torch.zeros((1, 56), dtype=torch.float32)
    rec[0, :16] = torch.tensor([-24536.0, 270978.0, -258189312.0, 37540.0, -414754.0, 395190272.0, -13088.0, 144722.0,
                                -137900032.0, -6.0318147006910294e-05, 0.0006792685599066317, -0.6455940008163452,
                                495.0, 0.0, 507.0, 999.0])
    tiles_x, t = 15, 124 * 15 + 3  # the tile holding pixel (482, 996)
    tile_start = torch.tensor([0] * (t + 1) + [1] * (15 * 135 - t), dtype=torch.int64)
    covered, outside, outside_setup = coverage_outside(tile_start, torch.zeros(1, dtype=torch.int64), rec,
                                                       torch.tensor([997], dtype=torch.int32), tiles_x)
    assert covered > 0 and outside == 0 and outside_setup > 0
    depth, vis = raster_tile.raster_plain(tile_start, torch.zeros(1, dtype=torch.int64), rec, 0,
                                          torch.zeros((1080, 1920)), torch.full((1080, 1920), -1, dtype=torch.int32),
                                          tiles_x)
    assert int(vis[996, 482]) == 0 and float(depth[996, 482]) > 0.0
