"""The alpha variants of the setup and tile-raster kernels' plain versions
(setup_plain with an opacity-mask table, raster_plain(alpha_test=True))
against the reference's Pallas kernels in interpret mode
(setup_fused.setup_compact with "alpha_hbm", rasterize_tiles(alpha_test=
True)), on the textured, alpha-classed small scene: every cluster of both
classes that the merged late pass keeps when nothing was visible before.

* setup: integers exact (count, tri_k/tri_t, AABB, ids, flat index) and
  the mask columns 48-55 exact -- the triangle's mask row for post-class
  clusters, exactly zero for the rest.  The other float columns carry the
  differences stated in tests/test_torch_setup.py.
* raster: the port's records fed to both sides onto a seeded carried
  depth/vis.  vis ids match exactly, on a scene where the masks discard
  2,077 pixels that the alpha records would win without the test.  Depth
  differs by the ulps stated in tests/test_torch_raster.py (XLA:CPU
  contracts the plane evaluation into FMAs): here max 32, 99th percentile
  4, median 0 (limits 64, 4, 1).  The same contraction moves the edge
  values that weigh the interpolated uv, so a pixel whose uv lay within
  rounding of a mask-cell border could fall on either side of it; none
  does on this scene.
* the two-quad punch-through case of tests/test_alpha.py through the port;
* the kernel's integer mask-bit extract against the reference's f32 form
  on every (16-bit half, cell) pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import cull as jcull
from niagara_tpu.ops import pyramid as jpyramid
from niagara_tpu.ops import raster as jraster
from niagara_tpu.ops import raster_tile as jrt
from niagara_tpu.ops import setup_fused
from niagara_tpu.render.camera import Camera, RenderSettings, make_cull_params
from niagara_tpu_torch import scene
from niagara_tpu_torch.ops import raster, raster_tile, setup
from niagara_tpu_torch.render import camera
from test_alpha import setup_two_quads
from test_alpha import H as QH
from test_alpha import W as QW
from test_torch_scene import CAPS, H, W, alpha_parity_scene

CAP = CAPS["tri_capacity"]
TX, TY = W // 128, H // 8
INVALID = 0x7FFFFFFF


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    ds, _ = alpha_parity_scene(tmp_path_factory.mktemp("mesh"))
    tds = scene.from_numpy(ds, "cpu")
    levels, ph, pw = jpyramid.pyramid_shape(W, H)
    jp, _ = make_cull_params(Camera(), W, H, pw, ph, RenderSettings())
    tp, _ = camera.make_cull_params(camera.Camera(), W, H, pw, ph, camera.RenderSettings())
    atlas = jnp.zeros((levels, ph, pw), jnp.float32)
    dvb = jnp.zeros(ds.num_draws, jnp.int32)
    words = jnp.zeros(-(-max(ds.meshlet_visibility_count, 64) // 64) * 2, jnp.uint32)
    kw = dict(late=True, pyramid_shape=(ph, pw))
    emit, lod, _ = jcull.draw_cull(ds, jp, dvb, atlas, num_classes=2, **kw)
    groups, *_ = jcull.cluster_cull_direct_multi(
        ds, jp, emit, lod, dvb, words, atlas, draw_capacity=CAPS["cmd_capacity"],
        cluster_capacity=CAPS["cluster_capacity"], candidate_capacity=CAPS["candidate_capacity"],
        num_classes=2, class_groups=((0, 1),), **kw)
    cdraw, cmi, count = groups[0]
    cdraw, cmi = jraster.order_clusters_by_x(ds, jp, cdraw, cmi, count)
    jtc = jraster.transform_meta_direct(ds, cdraw, cmi, count)
    assert "alpha_hbm" in jtc
    ref = setup_fused.setup_compact(jtc, jp, W, H, CAP, interpret=True)
    ttc = raster.transform_meta_direct(tds, torch.from_numpy(np.array(cdraw)).long(),
                                       torch.from_numpy(np.array(cmi)).long(), torch.tensor(int(count)))
    assert "alpha" in ttc
    return ref, setup.setup_plain(ttc, tds, tp, W, H, CAP)


def test_setup_alpha_matches_reference(setups):
    ref, got = setups
    n = int(ref["count"])
    assert n > 500 and int(got["count"]) == n and int(got["dropped"]) == int(ref["dropped"]) == 0
    for k in ("tri_k", "tri_t", "x0", "y0", "x1", "y1"):
        np.testing.assert_array_equal(got[k][:n].numpy(), np.asarray(ref[k][:n]), err_msg=k)
    a = np.asarray(ref["rec48"])[:n, : setup.REC]
    b = got["rec"][:n].numpy()
    exact = [12, 13, 14, 15, 22, 23, 30, 31, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47] + list(range(48, 56))
    np.testing.assert_array_equal(b[:, exact], a[:, exact])
    post = b[:, 45] > 0
    assert 0 < post.sum() < n, "both classes in the merged stream"
    assert (b[post, 54] > 0).all(), "every alpha-class record carries its mask"
    assert not b[~post, 48:56].any(), "opaque records carry exact zeros"
    assert not got["rec"][n:].any(), "rows past count are zero"


def _carry(seed):
    rng = np.random.default_rng(seed)
    hit = rng.random((H, W)) < 0.3
    depth = np.where(hit, rng.uniform(0.0, 0.05, (H, W)), 0.0).astype(np.float32)
    vis = np.where(hit, rng.integers(2 * CAP, 4 * CAP, (H, W)), INVALID).astype(np.int32)
    return depth, vis


def _jax_setup(st):
    return dict(valid=jnp.asarray(st["valid"].numpy()), rec48=jnp.asarray(st["rec"].numpy()),
                **{k: jnp.asarray(st[k].numpy()) for k in ("x0", "y0", "x1", "y1")})


def test_raster_alpha_matches_reference(setups):
    _, st = setups
    depth0, vis0 = _carry(5)
    kw = dict(tiles_x=TX, tiles_y=TY, pair_capacity=1 << 15, frag_offset=CAP)
    jd, jv, jstats = jrt.rasterize_tiles(_jax_setup(st), jrt.image_to_tiles(jnp.asarray(depth0), H, W),
                                         jrt.image_to_tiles(jnp.asarray(vis0), H, W), interpret=True,
                                         alpha_test=True, **kw)
    td, tv, tstats = raster_tile.rasterize_tiles(st, torch.from_numpy(depth0), torch.from_numpy(vis0),
                                                 alpha_test=True, **kw)
    for k in ("pair_count", "drop_vec", "demand_vec"):
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    ref_vis = np.asarray(jrt.tiles_to_image(jv, H, W))
    ref_depth = np.asarray(jrt.tiles_to_image(jd, H, W))
    got_vis, got_depth = tv.numpy(), td.numpy()

    # the masks discard: without the test the alpha records win more pixels
    _, opaque_vis, _ = raster_tile.rasterize_tiles(st, torch.from_numpy(depth0), torch.from_numpy(vis0), **kw)
    rec = st["rec"].numpy()
    ids = opaque_vis.numpy().astype(np.int64) - CAP
    alpha_won = (ids >= 0) & (ids < CAP) & (rec[np.clip(ids, 0, CAP - 1), 45] > 0)
    discarded = alpha_won & (got_vis != opaque_vis.numpy())
    assert discarded.sum() > 1000, discarded.sum()

    np.testing.assert_array_equal(got_vis, ref_vis)
    won = ref_vis < 2 * CAP
    ulps = np.abs(got_depth.view(np.int32).astype(np.int64) - ref_depth.view(np.int32).astype(np.int64))
    assert ulps.max() <= 64 and np.percentile(ulps[won], 99) <= 4 and np.median(ulps[won]) <= 1
    np.testing.assert_array_equal(got_depth[~won], ref_depth[~won])


def _two_quads_port(row):
    """tests/test_alpha.py's two quads: the reference's screen-space setup
    records (mask row injected) rasterized by the port's alpha variant."""
    st = setup_two_quads(row)
    n = st["valid"].shape[0]
    tst = dict(rec=torch.from_numpy(np.array(st["rec48"])[:, : setup.REC]),
               valid=torch.from_numpy(np.array(st["valid"])), count=torch.tensor(int(st["count"])),
               **{k: torch.from_numpy(np.array(st[k])).to(torch.int32) for k in ("x0", "y0", "x1", "y1")})
    assert tst["rec"].shape == (n, setup.REC)
    depth = torch.zeros((QH, QW))
    vis = torch.full((QH, QW), INVALID, dtype=torch.int32)
    depth, vis, _ = raster_tile.rasterize_tiles(tst, depth, vis, tiles_x=QW // 128, tiles_y=QH // 8,
                                                pair_capacity=1 << 10, alpha_test=True)
    return depth.numpy(), vis.numpy()


def test_two_quad_punch_through():
    """Left half of the near quad's mask clear: those pixels show the far
    quad (z 0.3), the rest the near one (z 0.6, with the post-class bias),
    pixel for pixel as the analytic oracle of tests/test_alpha.py; a zero
    mask row (idu 0) is no test at all."""
    cells = np.zeros((8, 8), bool)
    cells[:, 4:] = True
    m = (cells.reshape(64).astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(dtype=np.uint64)
    row = np.array([float((m >> np.uint64(16 * h)) & np.uint64(0xFFFF)) for h in range(4)] + [0, 0, 8, 8],
                   np.float32)
    depth, vis = _two_quads_port(row)
    near = np.floor((np.arange(QW) + 0.5) / QW * 8.0) >= 4.0
    np.testing.assert_allclose(depth[0], np.where(near, 0.6, 0.3).astype(np.float32), rtol=3e-6)
    assert (depth == depth[0]).all() and (vis != INVALID).all()
    depth, _ = _two_quads_port(np.zeros(8, np.float32))
    np.testing.assert_allclose(depth, np.full((QH, QW), 0.6, np.float32), rtol=3e-6)


def test_mask_bit_int_equals_float_form():
    """csrc/raster.cu takes the mask bit as (half >> (b & 15)) & 1; the
    reference as floor(half * 2^-(b mod 16)) mod 2 in f32.  Equal on all
    2^16 halves x 64 cells."""
    half = torch.arange(1 << 16, dtype=torch.float32)[:, None].expand(-1, 64)
    bb = torch.arange(64, dtype=torch.float32)[None, :].expand(1 << 16, -1)
    f = raster_tile.mask_bit_float(half, bb)
    i = (half.to(torch.int32) >> (bb.to(torch.int32) & 15)) & 1
    assert torch.equal(f, i.to(torch.float32))
    assert int(i.sum()) == 64 * (1 << 16) // 2  # each bit is set in half the halves
