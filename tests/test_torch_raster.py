"""Pair emission, tile raster and attribute resolve of niagara_tpu_torch
against the reference (raster_tile.emit_pairs, rasterize_tiles and
shade_tiles, kernels in interpret mode), fed the same setup records.

The records come from the port's setup of the parity scene's early-pass
clusters, split in two streams (the second at fragment offset
tri_capacity, as the frame's late pass), rasterized onto a seeded carried
depth/vis.

* emit_pairs: every output is an integer and matches exactly, with the
  class budgets at their defaults and squeezed until the tiny2 and small
  classes and the final sort drop.
* raster: vis ids match exactly; depth within the stated ulps.  XLA:CPU
  contracts the plane evaluation za*x + zb*y + zc into FMAs, and the terms
  can be ~100x the depth (the depth plane's coefficients cancel), so a few
  ulps of the terms show up as up to a few hundred ulps of the depth; the
  port, like its CUDA kernel under --fmad=false, rounds op by op.  On this
  scene: max 256 ulps, 99th percentile 2, median 0 (limits 512, 4, 1).
* shade: integer channels (draw, material, post, vertex ids) exactly;
  interpolated channels, for the same reason (the edge functions cancel
  near a triangle's edges), within 2.5e-4 of each channel's range (the
  worst here: 1.98e-4, the normal's z)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import raster_tile as jrt
from niagara_tpu_torch import scene
from niagara_tpu_torch.ops import cull, pyramid, raster, raster_tile, setup
from niagara_tpu_torch.render import camera
from test_torch_scene import CAPS, H, W, parity_scene

TX, TY = W // 128, H // 8
CAP = CAPS["tri_capacity"]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    _, ds = parity_scene(tmp_path_factory.mktemp("mesh"))
    tds = scene.from_numpy(ds, "cpu")
    levels, ph, pw = pyramid.pyramid_shape(W, H)
    tp, _ = camera.make_cull_params(camera.Camera(), W, H, pw, ph, camera.RenderSettings())
    atlas = torch.zeros((levels, ph, pw))
    dvb = torch.ones(tds.num_draws, dtype=torch.int32)
    words = torch.full((-(-max(tds.meshlet_visibility_count, 64) // 64) * 2,), 0xFFFFFFFF, dtype=torch.int64)
    emit, lod, _ = cull.draw_cull(tds, tp, dvb, atlas, late=False, pyramid_shape=(ph, pw))
    cdraw, cmi, count, *_ = cull.cluster_cull_direct(
        tds, tp, emit, lod, dvb, words, atlas, late=False, pyramid_shape=(ph, pw),
        draw_capacity=CAPS["cmd_capacity"], cluster_capacity=CAPS["cluster_capacity"],
        candidate_capacity=CAPS["candidate_capacity"])
    cdraw, cmi = raster.order_clusters_by_x(tds, tp, cdraw, cmi, count)
    half = int(count) // 2
    out = []
    for lo, hi in ((0, half), (half, int(count))):
        k = torch.arange(CAPS["cluster_capacity"])
        sel = torch.clamp(k + lo, max=CAPS["cluster_capacity"] - 1)
        tc = raster.transform_meta_direct(tds, cdraw[sel], cmi[sel], torch.tensor(hi - lo))
        out.append(setup.setup_plain(tc, tds, tp, W, H, CAP))
    return out


def _jax_setup(st):
    return dict(valid=jnp.asarray(st["valid"].numpy()), rec48=jnp.asarray(st["rec"].numpy()),
                **{k: jnp.asarray(st[k].numpy()) for k in ("x0", "y0", "x1", "y1")})


def _carry(seed):
    rng = np.random.default_rng(seed)
    hit = rng.random((H, W)) < 0.3
    depth = np.where(hit, rng.uniform(0.0, 0.05, (H, W)), 0.0).astype(np.float32)
    # carried ids lie outside both streams' id ranges
    vis = np.where(hit, rng.integers(2 * CAP, 4 * CAP, (H, W)), 0x7FFFFFFF).astype(np.int32)
    return depth, vis


@pytest.mark.parametrize("squeeze", [False, True])
def test_emit_pairs_matches_reference(streams, squeeze):
    st = streams[0]
    caps = dict(pair_capacity=1 << 15)
    if squeeze:  # tiny2, small and the final sort overflow
        caps = dict(pair_capacity=128, tiny2_capacity=16, small_capacity=8, mid_capacity=4,
                    midb_capacity=1, giant_capacity=0)
    ref = jrt.emit_pairs(_jax_setup(st), tiles_x=TX, tiles_y=TY, **caps)
    got = raster_tile.emit_pairs(st, tiles_x=TX, tiles_y=TY, **caps)
    names = ("pair_tri", "tile_start", "pair_count", "dropped", "drop_vec", "demand_vec")
    for name, r in zip(names, ref):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(r).astype(np.int64), err_msg=name)
    drops = got["drop_vec"].numpy()
    assert (drops[[0, 1, 5]] > 0).all() if squeeze else drops.sum() == 0
    assert (got["demand_vec"].numpy()[:3] > 0).all()


@pytest.fixture(scope="module")
def rastered(streams):
    """Both packages' raster of the two streams onto the seeded carry: (JAX
    raster stats per stream, the port's, JAX depth/vis tiles, the port's
    depth/vis); each stats dict holds the pass's record stream."""
    depth0, vis0 = _carry(3)
    jd = jrt.image_to_tiles(jnp.asarray(depth0), H, W)
    jv = jrt.image_to_tiles(jnp.asarray(vis0), H, W)
    td, tv = torch.from_numpy(depth0), torch.from_numpy(vis0)
    j_stats, t_stats = [], []
    for i, st in enumerate(streams):
        kw = dict(tiles_x=TX, tiles_y=TY, pair_capacity=1 << 15, frag_offset=i * CAP)
        jd, jv, jstats = jrt.rasterize_tiles(_jax_setup(st), jd, jv, interpret=True, **kw)
        td, tv, tstats = raster_tile.rasterize_tiles(st, td, tv, **kw)
        j_stats.append(jstats)
        t_stats.append(tstats)
    return j_stats, t_stats, jd, jv, td, tv


def test_raster_and_shade_match_reference(rastered):
    j_stats, t_stats, jd, jv, td, tv = rastered
    j_streams, t_streams = [s["stream"] for s in j_stats], [s["stream"] for s in t_stats]
    for jstats, tstats in zip(j_stats, t_stats):
        for k in ("pair_count", "drop_vec", "demand_vec"):
            np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)

    ref_depth = np.asarray(jrt.tiles_to_image(jd, H, W))
    ref_vis = np.asarray(jrt.tiles_to_image(jv, H, W))
    got_depth, got_vis = td.numpy(), tv.numpy()
    np.testing.assert_array_equal(got_vis, ref_vis)
    won = ref_vis < 2 * CAP  # pixels a record of either stream won
    assert won.sum() > 2000 and (won & (ref_vis >= CAP)).sum() > 500, "both streams win pixels"
    ulps = np.abs(got_depth.view(np.int32).astype(np.int64) - ref_depth.view(np.int32).astype(np.int64))
    assert ulps.max() <= 512 and np.percentile(ulps[won], 99) <= 4 and np.median(ulps[won]) <= 1
    np.testing.assert_array_equal(got_depth[~won], ref_depth[~won])

    ref_attr = np.asarray(jrt.attr_tiles_to_image(jrt.shade_tiles(j_streams, jv, tiles_x=TX, interpret=True), H, W))
    got_attr = raster_tile.shade_tiles(t_streams, tv).numpy()
    np.testing.assert_array_equal(got_attr[..., 6:12], ref_attr[..., 6:12])
    for ch in range(raster_tile.ATTR_CHANNELS):
        a, b = got_attr[..., ch], ref_attr[..., ch]
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-4 * np.abs(b).max(), err_msg=f"channel {ch}")
    assert (got_attr[~won] == 0).all(), "carried ids and empty pixels resolve to no record"


def test_shade_edge_pixels_match_reference(rastered):
    """The two streams over the rastered vis with a seeded random tenth of
    the pixels cleared to 0x7FFFFFFF and another tenth set to ids in the
    gap past the early stream's count (below the late stream's offset):
    both packages give zero planes there and the same planes elsewhere,
    the integer channels exactly, the interpolated ones within
    test_raster_and_shade_match_reference's tolerance (2.5e-4 of each
    channel's range: XLA:CPU contracts the edge functions into FMAs)."""
    j_stats, t_stats, _, _, _, tv = rastered
    j_streams, t_streams = [s["stream"] for s in j_stats], [s["stream"] for s in t_stats]
    count0 = int(t_streams[0]["count"])
    assert count0 + 100 < t_streams[1]["frag_off"] == CAP
    rng = np.random.default_rng(17)
    pick = rng.random((H, W))
    cleared, gap = pick < 0.1, (pick >= 0.1) & (pick < 0.2)
    vis = tv.numpy().copy()
    won = vis < 2 * CAP
    assert (cleared & won).sum() > 200 and (gap & won).sum() > 200 and (gap & (vis >= CAP) & won).sum() > 50
    vis[cleared] = 0x7FFFFFFF
    vis[gap] = rng.integers(count0, CAP, int(gap.sum()))
    ref_attr = np.asarray(jrt.attr_tiles_to_image(
        jrt.shade_tiles(j_streams, jrt.image_to_tiles(jnp.asarray(vis), H, W), tiles_x=TX, interpret=True), H, W))
    got_attr = raster_tile.shade_tiles(t_streams, torch.from_numpy(vis)).numpy()
    off = cleared | gap
    assert (got_attr[off] == 0).all() and (ref_attr[off] == 0).all(), "no record resolves there"
    keep = ~off & won
    assert keep.sum() > 2000
    np.testing.assert_array_equal(got_attr[..., 6:12], ref_attr[..., 6:12])
    for ch in range(raster_tile.ATTR_CHANNELS):
        a, b = got_attr[..., ch][keep], ref_attr[..., ch][keep]
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-4 * np.abs(b).max(), err_msg=f"channel {ch}")


def test_shade_kernel_takes_one_to_four_streams(streams):
    """shade_cuda raises on no stream and on more than four, before it
    looks at the device; on a CPU tensor it has no kernel and raises too
    (shade_tiles takes the plain version there, for any stream count)."""
    vis = torch.full((H, W), 0x7FFFFFFF, dtype=torch.int32)
    one = dict(rec=streams[0]["rec"], count=streams[0]["count"], frag_off=0)
    for n in (0, 5):
        with pytest.raises(ValueError, match="1 to 4 record streams"):
            raster_tile.shade_cuda([one] * n, vis)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        raster_tile.shade_cuda([one] * 4, vis)
    five = [dict(one, frag_off=i * CAP) for i in range(5)]
    assert (raster_tile.shade_tiles(five, vis) == 0).all()


def test_rasterize_class_caps_match_reference(streams):
    """Explicit (tiny2, small, midA, midB) budgets (FrameConfig's
    pair_class_caps) reach pair emission as in the reference's
    rasterize_tiles: same drops, demand and raster result."""
    st = streams[0]
    depth0, vis0 = _carry(4)
    kw = dict(tiles_x=TX, tiles_y=TY, pair_capacity=1 << 15, class_caps=(64, 32, 4, 1))
    jd, jv, jstats = jrt.rasterize_tiles(_jax_setup(st), jrt.image_to_tiles(jnp.asarray(depth0), H, W),
                                         jrt.image_to_tiles(jnp.asarray(vis0), H, W), interpret=True, **kw)
    td, tv, tstats = raster_tile.rasterize_tiles(st, torch.from_numpy(depth0), torch.from_numpy(vis0), **kw)
    for k in ("pair_count", "drop_vec", "demand_vec"):
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    assert (tstats["drop_vec"].numpy()[:3] > 0).all(), "tiny2, small and midA budgets overflow"
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jrt.tiles_to_image(jv, H, W)))
