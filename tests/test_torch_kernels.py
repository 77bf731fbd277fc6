"""The CUDA kernels of niagara_tpu_torch against their plain torch versions
on the card, on the small scene at 256x128 (cooker.small_scene_draws): setup,
tile raster and shade must agree exactly, since both sides round every op
as IEEE f32 (the kernels are built with --fmad=false).  The same for the
alpha variants of setup and raster on the textured, alpha-classed small
scene (cooker.small_alpha_scene, post_passes=2), and for the row_window
variant of raster (a band of tile rows, both instances).  Stress cases
hold both kernels to their plain versions where the small frames do not
reach: crafted records (tests/test_torch_raster_box.py::crafted_setup)
with more than one staged batch in a tile, empty tiles, all-tie merges,
boxes over many tiles and a band; setup with part-filled and wholly
culled clusters, more triangles than capacity, an odd live cluster count
and a single live cluster; shade with 1 to 4 seeded random record streams,
ids in the gaps between them, uncovered pixels, degenerate records and a
framebuffer one tile wide.  The transmission frame (small_glass_scene,
post_passes=3): every pass's setup and raster, the third group's into its
own layer, and the layer's one-stream shade against their plain versions,
and the normal-mapped frame on the card against the CPU; the single-pass
early pass of configs 0 and 1; the viewer on the card (PNGs, CUDA-event
frame times, debug views and HUD equal to the CPU's).  The bloom kernels (csrc/bloom.cu) against
their plain versions bit for bit on seeded nonzero inputs at odd sizes,
and compute_bloom's kernel path against its plain path.  The BVH walk
(csrc/trace.cu, both instances) against trace_plain on seeded rays: flags
and per-ray step counts equal, a budget that cuts rays short too; and the
ray-traced frame on the card against the CPU.  And the G-buffer
and composite on the card against the CPU: the emissive channel's and the
NDC planes' divisions bit for bit, the rest within 2e-6.  Animation
playback on the card (its default device) against the CPU within 2e-6.

Marked `cuda`: skipped where there is no GPU.  On a GPU machine (no JAX
there, so without tests/conftest.py) run
`python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q`.
These do not replace chip_smoke.py, which checks the same at headline
size."""

import numpy as np
import pytest
import torch

from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import bloom, cullmath, raster_tile, setup, shade, shadow
from niagara_tpu_torch.render import animation, camera, frame, hud, presets, textures
from test_torch_raster_box import crafted_setup, screen_triangles

W, H = 256, 128
DEV = "cuda"

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    g = cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))
    tds = scene.from_numpy(scene.upload(g, cooker.small_scene_draws(g.meshes.count)), "cuda")
    cfg = frame.FrameConfig(width=W, height=H, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cuda")
    capture = {}
    for _ in range(2):
        _, _, state, _ = frame.render_frame(tds, state, params, sp, cfg, capture=capture)
    return tds, params, cfg, capture


def test_setup_kernel_matches_plain(captured):
    tds, params, cfg, capture = captured
    for tc, cap in capture["setup"]:
        before = _build.LAUNCHES["setup"]
        got = setup.setup_cuda(tc, tds, params, W, H, cap)
        assert _build.LAUNCHES["setup"] == before + 1
        ref = setup.setup_plain(tc, tds, params, W, H, cap)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_raster_kernel_matches_plain(captured):
    _, _, cfg, capture = captured
    tx = cfg.width // 128
    ts, pt, rec, off, d0, v0 = capture["raster"][0]
    # plus a tie merge: the early records onto their own result at a higher
    # id offset -- every covered pixel ties and goes to the smaller id
    shifted = raster_tile.raster_cuda(ts, pt, rec, off + cfg.tri_capacity, d0, v0, tx)
    for args in (*capture["raster"], (ts, pt, rec, off, *shifted)):
        kd, kv = raster_tile.raster_cuda(*args, tx)
        pd, pv = raster_tile.raster_plain(*args, tx)
        assert torch.equal(kv, pv) and torch.equal(kd, pd)


def test_shade_kernel_matches_plain(captured):
    _, _, _, capture = captured
    streams, vis = capture["shade"]
    got = raster_tile.shade_cuda(streams, vis)
    assert torch.equal(got, raster_tile.shade_plain(streams, vis))
    assert int((vis != 0x7FFFFFFF).sum()) > 2000


def _shade_streams(rng, n_streams):
    """n_streams seeded random record streams, each with rows past its
    count (NaN: no pixel may read them) and a gap of unused ids before the
    next stream's offset.  Of the live records a fifth have all-zero edge
    equations (wsum == 0, the inv = 0 branch) and a fifth corners whose
    pixel area is under 1e-6 (the duv clamp).  Returns (streams, live id
    ranges, dead id ranges)."""
    streams, live, dead, off = [], [], [(0, 5)], 5
    for _ in range(n_streams):
        count, cap = int(rng.integers(50, 400)), int(rng.integers(400, 500))
        rec = rng.normal(0.0, 3.0, (cap, 56)).astype(np.float32)
        rec[:, 0:9] = rng.uniform(-1e-4, 1e-4, (cap, 9))
        rec[:, 2:9:3] = rng.uniform(0.2, 1.0, (cap, 3))  # e0, e1, e2 > 0.15 on the frame
        rec[:, 16:40:8] = rng.uniform(0.0, 100.0, (cap, 3))  # corner x, y (cols 16/17, 24/25, 32/33)
        rec[:, 17:40:8] = rng.uniform(0.0, 100.0, (cap, 3))
        rec[:, 40:46] = rng.integers(0, 1 << 20, (cap, 6))
        kind = rng.integers(0, 5, cap)
        rec[kind == 0, 0:9] = 0.0
        tiny = kind == 1
        rec[tiny, 24] = rec[tiny, 16] + 1e-4
        rec[tiny, 25] = rec[tiny, 17]
        rec[tiny, 32] = rec[tiny, 16] + 2e-4
        rec[tiny, 33] = rec[tiny, 17] + 1e-3
        rec[count:] = np.nan
        streams.append(dict(rec=torch.as_tensor(rec, device=DEV), count=torch.tensor(count, device=DEV),
                            frag_off=off))
        live.append((off, off + count))
        gap = int(rng.integers(1, 300))
        dead.append((off + count, off + cap + gap))
        off += cap + gap
    dead.append((off, off + 1000))
    return streams, live, dead


@pytest.mark.parametrize("n_streams, width, height", [(1, 128, 48), (2, 384, 40), (3, 128, 72), (4, 256, 33)])
def test_shade_kernel_stress(n_streams, width, height):
    """Seeded random streams and a vis buffer with ids in each stream, in
    the gaps (below the first offset, past each count, after the last
    stream), and 0x7FFFFFFF; a framebuffer one tile wide and a height that
    is no multiple of the kernel's rows a block.  The kernel equals
    shade_plain bit for bit, and uncovered pixels are zero."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    rng = np.random.default_rng(23 + n_streams)
    streams, live, dead = _shade_streams(rng, n_streams)
    ranges = live + dead + [(0x7FFFFFFF, 0x80000000)]
    # each pixel's range, then an id in it; pairs of pixels along a row share
    # an id, as a frame's triangles give runs
    pick = rng.integers(0, len(ranges), (height, width // 2)).repeat(2, axis=1)
    frac = rng.random((height, width // 2)).repeat(2, axis=1)
    lo, hi = (np.array([r[k] for r in ranges]) for k in (0, 1))
    vis = torch.as_tensor((lo[pick] + frac * (hi - lo)[pick]).astype(np.int64).astype(np.int32), device=DEV)
    assert len(np.unique(pick)) == len(ranges)
    before = _build.LAUNCHES["shade"]
    got = raster_tile.shade_cuda(streams, vis)
    assert _build.LAUNCHES["shade"] == before + 1
    ref = raster_tile.shade_plain(streams, vis)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), "not bit for bit"
    covered = torch.as_tensor(pick < n_streams, device=DEV)
    assert not got[~covered].any(), "pixels in no stream's range are zero"
    assert bool(torch.isfinite(got[covered]).all())
    assert (got[covered][:, :6] == 0).all(dim=1).any(), "some pixels resolve to a record with wsum == 0"


@pytest.fixture(scope="module")
def alpha_captured(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    g = cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))
    g, draws, materials, masks, mips = cooker.small_alpha_scene(g)
    table = textures.build_texture_table(mips)
    tds = scene.from_numpy(scene.upload(g, draws, materials, masks, texture_table=table), "cuda")
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cuda")
    tex = textures.to_device(table, "cuda")
    capture = {}
    for _ in range(2):
        _, _, state, _ = frame.render_frame(tds, state, params, sp, cfg, textures=tex, capture=capture)
    return tds, params, cfg, capture


def test_setup_alpha_kernel_matches_plain(alpha_captured):
    tds, params, cfg, capture = alpha_captured
    for tc, cap in capture["setup"]:
        assert "alpha" in tc
        before = _build.LAUNCHES["setup_alpha"]
        got = setup.setup_cuda(tc, tds, params, W, H, cap)
        assert _build.LAUNCHES["setup_alpha"] == before + 1
        ref = setup.setup_plain(tc, tds, params, W, H, cap)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    n = int(got["count"])
    assert (got["rec"][:n, 54] > 0).any(), "the late pass carries masked records"


def test_raster_alpha_kernel_matches_plain(alpha_captured):
    _, _, cfg, capture = alpha_captured
    tx = cfg.width // 128
    assert capture["raster_alpha_test"] == (False, True)
    ts, pt, rec, off, d0, v0 = capture["raster"][1]
    shifted = raster_tile.raster_cuda(ts, pt, rec, off + cfg.late_tri_cap, d0, v0, tx, alpha_test=True)
    results = []
    for args in (capture["raster"][1], (ts, pt, rec, off, *shifted)):
        before = _build.LAUNCHES["raster_alpha"]
        kd, kv = raster_tile.raster_cuda(*args, tx, alpha_test=True)
        assert _build.LAUNCHES["raster_alpha"] == before + 1
        pd, pv = raster_tile.raster_plain(*args, tx, alpha_test=True)
        assert torch.equal(kv, pv) and torch.equal(kd, pd)
        results.append(kv)
    assert torch.equal(*results), "the tie merge gives the pass's result"
    _, opaque = raster_tile.raster_cuda(*capture["raster"][1], tx)
    assert not torch.equal(opaque, results[0]), "the masks discard pixels"


def test_raster_window_kernel_matches_plain(alpha_captured):
    """The raster kernel on a band of tile rows (band_row0 > 0), both
    instances: equal to raster_plain and to the full raster's rows."""
    _, _, cfg, capture = alpha_captured
    tx, ty = cfg.width // 128, cfg.height // 8
    st = capture["setup_out"][1]
    _, _, rec, off, d0, v0 = capture["raster"][1]
    for alpha in (True, False):
        full = raster_tile.emit_pairs(st, tiles_x=tx, tiles_y=ty, pair_capacity=cfg.late_pair_cap)
        fd, fv = raster_tile.raster_cuda(full["tile_start"], full["pair_tri"], rec, off, d0, v0, tx, alpha_test=alpha)
        pairs = raster_tile.emit_pairs(st, tiles_x=tx, tiles_y=ty, pair_capacity=cfg.late_pair_cap, row_window=(5, 6))
        args = (pairs["tile_start"], pairs["pair_tri"], rec, off, d0[40:88], v0[40:88], tx)
        name = "raster_alpha_window" if alpha else "raster_window"
        before = _build.LAUNCHES[name]
        kd, kv = raster_tile.raster_cuda(*args, alpha_test=alpha, band_row0=5)
        assert _build.LAUNCHES[name] == before + 1
        pd, pv = raster_tile.raster_plain(*args, alpha_test=alpha, band_row0=5)
        assert torch.equal(kv, pv) and torch.equal(kd, pd)
        assert torch.equal(kv, fv[40:88]) and torch.equal(kd, fd[40:88])


def _random_triangles(rng, n, width, height, size):
    """n front-facing triangles in pixels (w = 1), corners within `size`
    of a random anchor, depths in (0.05, 0.95)."""
    a = rng.uniform([0, 0], [width, height], (n, 1, 2))
    xy = a + rng.uniform(-size, size, (n, 3, 2))
    return screen_triangles(xy, rng.uniform(0.05, 0.95, (n, 3)))


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha_test"])
def test_raster_kernel_stress(alpha):
    """Crafted records: 12,000 small triangles crowded into the left half
    of a 512x64 frame (over a thousand records, several staged batches,
    per tile) and 80 large ones spanning many tiles, the right quarter's
    tiles empty; a tie merge; a band of tile rows; with random opacity
    masks."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    rng = np.random.default_rng(11)
    width, height = 512, 64
    corners = np.concatenate([_random_triangles(rng, 12000, width // 2, height, 6.0),
                              _random_triangles(rng, 80, width // 2, height, 100.0)])
    masks = uv = None
    if alpha:  # 4 random mask halves, cells 1/8 of the uv unit square
        masks = np.concatenate([rng.integers(0, 1 << 16, (len(corners), 4)),
                                np.tile([0.0, 0.0, 8.0, 8.0], (len(corners), 1))], axis=1)
        uv = rng.uniform(0.0, 1.0, (len(corners), 3, 2))
    st = crafted_setup(corners, width, height, masks=masks, uv=uv, capacity=1 << 14, device=DEV)
    tx, ty = width // 128, height // 8
    pairs = raster_tile.emit_pairs(st, tiles_x=tx, tiles_y=ty, pair_capacity=1 << 16)
    per_tile = torch.diff(pairs["tile_start"])
    assert int(per_tile.max()) > 2 * 512 and int((per_tile == 0).sum()) > 0 and int(pairs["dropped"]) == 0
    d0 = torch.zeros((height, width), device=DEV)
    v0 = torch.full((height, width), 0x7FFFFFFF, dtype=torch.int32, device=DEV)
    args = (pairs["tile_start"], pairs["pair_tri"], st["rec"], 0, d0, v0, tx)
    kd, kv = raster_tile.raster_cuda(*args, alpha_test=alpha)
    pd, pv = raster_tile.raster_plain(*args, alpha_test=alpha)
    assert torch.equal(kv, pv) and torch.equal(kd, pd)
    assert int((kv != 0x7FFFFFFF).sum()) > width * height // 4
    if alpha:
        assert not torch.equal(kv, raster_tile.raster_cuda(*args)[1]), "the masks discard pixels"
    # every covered pixel ties with its own result at a higher id offset
    shifted = raster_tile.raster_cuda(pairs["tile_start"], pairs["pair_tri"], st["rec"], 1 << 20, d0, v0, tx,
                                      alpha_test=alpha)
    td, tv = raster_tile.raster_cuda(*args[:4], *shifted, tx, alpha_test=alpha)
    assert torch.equal(tv, kv) and torch.equal(td, kd)
    band = raster_tile.emit_pairs(st, tiles_x=tx, tiles_y=ty, pair_capacity=1 << 16, row_window=(3, 4))
    bargs = (band["tile_start"], band["pair_tri"], st["rec"], 0, d0[24:56], v0[24:56], tx)
    bd, bv = raster_tile.raster_cuda(*bargs, alpha_test=alpha, band_row0=3)
    assert torch.equal(bv, raster_tile.raster_plain(*bargs, alpha_test=alpha, band_row0=3)[1])
    assert torch.equal(bv, kv[24:56]) and torch.equal(bd, kd[24:56])


@pytest.mark.parametrize("case", ["part_filled", "all_culled", "over_capacity", "odd_count", "one_cluster"])
def test_setup_kernel_stress(captured, case):
    """The early pass's clusters, changed: triangle counts cut below 96,
    a cluster moved behind the eye (all its triangles culled), a capacity
    below the count, an odd live cluster count, a single live cluster."""
    tds, params, _, capture = captured
    tc, cap = capture["setup"][0]
    tc = dict(tc)
    live = int(tc["count"][0])
    assert live > 8
    rng = np.random.default_rng(5)
    if case == "part_filled":
        cut = torch.as_tensor(rng.integers(0, 97, tc["tri_count"].shape[0]), device=DEV)
        tc["tri_count"] = torch.minimum(tc["tri_count"], cut.to(tc["tri_count"].dtype))
    elif case == "all_culled":
        xf = tc["xform"].clone()
        xf[live // 2, 3] = 0.0  # scale 0: every triangle degenerate, none front-facing
        tc["xform"] = xf
    elif case == "over_capacity":
        cap = 97
    elif case == "odd_count":
        tc["count"] = torch.tensor([live - 1 if live % 2 == 0 else live], device=DEV)
    else:
        tc["count"] = torch.ones(1, dtype=tc["count"].dtype, device=DEV)
    got = setup.setup_cuda(tc, tds, params, W, H, cap)
    ref = setup.setup_plain(tc, tds, params, W, H, cap)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    n = int(ref["count"])
    assert n > 0 and (int(ref["dropped"]) > 0) == (case == "over_capacity")
    if case == "all_culled":
        assert not (ref["tri_k"][:n] == live // 2).any()


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("h, w", [(37, 23), (38, 24), (1, 1), (2, 3), (540, 960)])
def test_bloom_kernels_match_plain(h, w):
    """One level of each filter on seeded nonzero [3, h, w] sources: down
    to ((h+1)/2, (w+1)/2), up (plus a seeded finer mip) and the x2
    expansion to (2h, 2w) and (2h-1, 2w-1); each launch counted."""
    _need_cuda()
    rng = np.random.default_rng(h * 1000 + w)
    src = torch.as_tensor(rng.uniform(0.0, 8.0, (3, h, w)).astype(np.float32), device=DEV)
    before = dict(_build.LAUNCHES)
    assert torch.equal(_bits(bloom.down2_cuda(src)), _bits(bloom._down2(src)))
    for oh, ow in [(2 * h, 2 * w), (max(2 * h - 1, 1), max(2 * w - 1, 1))]:
        mip = torch.as_tensor(rng.uniform(0.0, 8.0, (3, oh, ow)).astype(np.float32), device=DEV)
        assert torch.equal(_bits(bloom.up2_add_cuda(src, mip)), _bits(bloom.up2_add_plain(src, mip)))
        got = bloom.bilinear_x2_cuda(src, oh, ow)
        assert got.shape == (oh, ow, 3)
        assert torch.equal(_bits(got), _bits(bloom._bilinear_x2(src, oh, ow).permute(1, 2, 0)))
    assert {k: _build.LAUNCHES[k] - before[k] for k in ("bloom_down", "bloom_up", "bloom_x2")} == \
        {"bloom_down": 1, "bloom_up": 2, "bloom_x2": 2}


@pytest.mark.parametrize("h, w", [(128, 256), (23, 37)])
def test_compute_bloom_kernel_path_matches_plain_path(h, w):
    """The whole chain and the full-resolution expansion on a seeded g0
    with nonzero emissive: the kernel path equals the plain filters on the
    same card bit for bit (the extract is plain torch on both)."""
    _need_cuda()
    rng = np.random.default_rng(h + w)
    g0 = torch.as_tensor(rng.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32), device=DEV)
    half = bloom.compute_bloom(g0, w, h)
    assert torch.equal(_bits(half), _bits(bloom.bloom_chain(g0, w, h, bloom._down2, bloom.up2_add_plain)))
    full = bloom.sample_bloom_fullres(half, w, h)
    assert torch.equal(_bits(full), _bits(bloom._bilinear_x2(half, h, w).permute(1, 2, 0)))
    assert bool((half > 0).all())


def test_gbuffer_and_composite_divide_once_on_the_card(tmp_path):
    """gbuffer_from_attrs + composite with nonzero emissive materials on the
    card and on the CPU, same inputs.  g0's emissive channel equals the
    CPU's one IEEE division of the card's own log2 (so the division is the
    same single rounding), the NDC planes are bit-identical, and the whole
    G-buffer and image (with bloom) lie within 2e-6: log2, pow and exp2
    differ between the two math libraries."""
    _need_cuda()
    g = cooker.cook_procedural(str(tmp_path))
    draws = cooker.small_scene_draws(g.meshes.count)
    rng = np.random.default_rng(11)
    nm = 5
    materials = {"diffuse": rng.uniform(0.1, 1.0, (nm, 4)).astype(np.float32),
                 "specular": rng.uniform(0.0, 1.0, (nm, 4)).astype(np.float32),
                 "emissive": rng.uniform(0.0, 3.0, (nm, 3)).astype(np.float32)}
    draws.material_index[:] = rng.integers(0, nm, draws.count)
    np_scene = scene.upload(g, draws, materials)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    attrs = np.concatenate([nrm, rng.uniform(0, 4, (H, W, 5)).astype(np.float32), np.zeros((H, W, 5), np.float32)],
                           axis=-1)
    attrs[..., 7] = rng.integers(0, nm, (H, W))
    valid = rng.random((H, W)) < 0.8
    depth = rng.uniform(0.01, 1.0, (H, W)).astype(np.float32)
    cfg = frame.FrameConfig(width=W, height=H, **presets.small_capacities())
    _, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    out = {}
    for dev in ("cpu", DEV):
        sc = scene.from_numpy(np_scene, dev)
        a, v = torch.as_tensor(attrs, device=dev), torch.as_tensor(valid, device=dev)
        g0, g1, vv = shade.gbuffer_from_attrs(a, v, sc)
        b = bloom.sample_bloom_fullres(bloom.compute_bloom(g0, W, H), W, H)
        img = shade.composite(g0, g1, torch.as_tensor(depth, device=dev), vv, camera_position=sp.camera_position,
                              sun_direction=sp.sun_direction, inverse_view_projection=sp.inverse_view_projection,
                              width=W, height=H, bloom=b)
        out[dev] = (g0, g1, vv, img, sc, a)
    g0c, g1c, vc, imgc, _, _ = out["cpu"]
    g0g, g1g, vg, imgg, sc, a = out[DEV]
    assert torch.equal(vc, vg.cpu())
    # the card's own emissive ratio and log2, divided once on the CPU
    row = sc.mat_row[a[..., 7].to(torch.int64)]
    lum = shade._LUM
    emissivef = cullmath.dot3(row[..., 8:11], lum) / (cullmath.dot3(row[..., 0:3], lum) + 1e-3)
    want = torch.where(vc, torch.log2(1.0 + emissivef).cpu() / 5.0, 0.0)
    assert bool((want[vc] > 0).all())
    assert torch.equal(_bits(g0g[..., 3].cpu()), _bits(want))
    for cpu_plane, card_plane in zip(shade.ndc_planes(W, H, "cpu"), shade.ndc_planes(W, H, DEV)):
        assert torch.equal(_bits(cpu_plane), _bits(card_plane.cpu()))
    for x, y in ((g0c, g0g), (g1c, g1g), (imgc, imgg)):
        assert float((x - y.cpu()).abs().max()) <= 2e-6


def test_animation_on_the_card_matches_cpu(captured):
    """evaluate on its default device (the card) and on the CPU for a
    two-track table (one track starting late and wrapping, one rotating),
    and apply_to_draws on the small scene's card tensors: the indices and
    active flags equal, positions, scales and orientations within 2e-6
    (sin and arccos differ between the two math libraries), untracked
    draws untouched."""
    tds = captured[0]
    rot = np.array([[0, 0, 0, 1], [0, 0.3826834, 0, 0.9238795], [0, 0.7071068, 0, 0.7071068],
                    [0, 0, 0.6, -0.8]], np.float32)
    table = animation.AnimationTable(
        draw_index=np.array([0, 1], np.int32), light_index=np.array([-1, -1], np.int32),
        start_time=np.array([0.0, 0.4], np.float32), period=np.array([1 / 30, 0.25], np.float32),
        key_offset=np.array([0, 3], np.int32), key_count=np.array([3, 4], np.int32),
        key_translation=np.random.default_rng(3).normal(size=(7, 3)).astype(np.float32),
        key_scale=np.array([1, 2, 1, 0.5, 1, 1.5, 2], np.float32),
        key_rotation=np.concatenate([np.tile(np.array([[0, 0, 0, 1]], np.float32), (3, 1)), rot]))
    for t in (0.0, 0.2, 0.55, 1.3, 7.77):
        card, cpu = animation.evaluate(table, t), animation.evaluate(table, t, "cpu")
        assert card[1].device.type == "cuda"
        assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[4].cpu(), cpu[4])
        for x, y in zip(card[1:4], cpu[1:4]):
            assert float((x.cpu() - y).abs().max()) <= 2e-6
        moved = animation.apply_to_draws(tds, table, t)
        live = cpu[4].nonzero()[:, 0]
        assert float((moved.draw_position[live].cpu() - cpu[1][live]).abs().max()) <= 2e-6
        assert float((moved.draw_orientation[live].cpu() - cpu[3][live]).abs().max()) <= 2e-6
        assert torch.equal(moved.draw_xform_row[2:], tds.draw_xform_row[2:])


def _glass_frames(tmp_path, device):
    """Two frames of cooker.small_glass_scene (post_passes=3) on `device`,
    captured."""
    g = cooker.cook_procedural(str(tmp_path))
    g, draws, materials, masks, mips = cooker.small_glass_scene(g)
    table = textures.build_texture_table(mips)
    tds = scene.from_numpy(scene.upload(g, draws, materials, masks, texture_table=table), device)
    cfg = frame.FrameConfig(width=W, height=H, post_passes=3, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, device)
    tex = textures.to_device(table, device)
    capture = {}
    for _ in range(2):
        image, _, state, _ = frame.render_frame(tds, state, params, sp, cfg, textures=tex, capture=capture)
    return tds, params, sp, cfg, tex, capture, image


def test_glass_kernels_match_plain(tmp_path):
    """The transmission frame's kernel calls: the third group's setup (the
    alpha variant: the scene has masks) and its opaque-variant raster into
    the cleared layer, and the layer's one-stream shade, each equal to its
    plain version; the first two passes too."""
    _need_cuda()
    tds, params, _, cfg, _, capture, _ = _glass_frames(tmp_path, DEV)
    tx = cfg.width // 128
    assert capture["passes"] == ["early", "late", "glass"]
    assert capture["raster_alpha_test"] == (False, True, False)
    for tc, cap in capture["setup"]:
        got = setup.setup_cuda(tc, tds, params, W, H, cap)
        ref = setup.setup_plain(tc, tds, params, W, H, cap)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    ts, pt, rec, off, d0, v0 = capture["raster"][2]
    assert off == cfg.tri_capacity + cfg.late_tri_cap and not bool((v0 != 0x7FFFFFFF).any())
    for args, alpha in zip(capture["raster"], capture["raster_alpha_test"]):
        kd, kv = raster_tile.raster_cuda(*args, tx, alpha_test=alpha)
        pd, pv = raster_tile.raster_plain(*args, tx, alpha_test=alpha)
        assert torch.equal(kv, pv) and torch.equal(kd, pd)
    for streams, vis in (capture["shade"], capture["shade_layer"]):
        assert torch.equal(_bits(raster_tile.shade_cuda(streams, vis)), _bits(raster_tile.shade_plain(streams, vis)))
    assert len(capture["shade_layer"][0]) == 1 and int((capture["shade_layer"][1] != 0x7FFFFFFF).sum()) > 500


def test_glass_frame_on_the_card_matches_cpu(tmp_path):
    """The normal-mapped transmission frame on the card against the CPU:
    the layer's depth and vis and the shade-time masks exact, the image
    within 2e-6 (pow, exp2 and the sRGB decode differ between the math
    libraries; the tangent frame's square roots and divisions are IEEE on
    both)."""
    _need_cuda()
    card = _glass_frames(tmp_path, DEV)
    cpu = _glass_frames(tmp_path, "cpu")
    for k in ("depth", "vis", "valid"):
        assert torch.equal(card[5]["layer"][k].cpu(), cpu[5]["layer"][k]), k
    assert torch.equal(card[5]["valid"].cpu(), cpu[5]["valid"])
    assert float((card[6].cpu() - cpu[6]).abs().max()) <= 2e-6


@pytest.mark.parametrize("config", [0, 1])
def test_single_pass_kernels_match_plain(captured, config):
    """Configs 0 and 1 (occlusion_two_pass=False): one early pass, its
    setup, raster and shade equal to their plain versions."""
    tds = captured[0]
    cfg = frame.FrameConfig(width=W, height=H, **presets.small_capacities(), **presets.frame_overrides(config))
    params, sp = frame.make_frame_inputs(camera.Camera(), presets.settings_for(config), cfg)
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, DEV)
    capture = {}
    for _ in range(2):
        _, _, state, _ = frame.render_frame(tds, state, params, sp, cfg, capture=capture)
    assert capture["passes"] == ["early"]
    (tc, cap), = capture["setup"]
    got, ref = setup.setup_cuda(tc, tds, params, W, H, cap), setup.setup_plain(tc, tds, params, W, H, cap)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    args = (*capture["raster"][0], W // 128)
    assert all(torch.equal(a, b) for a, b in zip(raster_tile.raster_cuda(*args), raster_tile.raster_plain(*args)))
    streams, vis = capture["shade"]
    assert torch.equal(_bits(raster_tile.shade_cuda(streams, vis)), _bits(raster_tile.shade_plain(streams, vis)))


def test_viewer_on_the_card(captured, tmp_path, monkeypatch):
    """render_scene on its default device: PNGs with the HUD, frame times
    from CUDA events, the debug view equal to the CPU's on the same
    inputs, and the HUD bit for bit."""
    from niagara_tpu_torch import render_scene

    cam = tmp_path / "cam.json"
    at = cooker.synthesize_draws(1, 1).position[0] + np.float32([0, 0, 6])
    camera.save_camera(str(cam), camera.Camera(position=at))
    monkeypatch.setattr(render_scene, "VIEWER_CAPACITIES", presets.small_capacities())
    r = render_scene.run(["--size", f"{W}x{H}", "--draws", "300", "--frames", "2",
                          "--out", str(tmp_path), "--camera", str(cam)])
    assert r["fb"].vis.device.type == "cuda" and len(r["paths"]) == 2 and min(r["frame_ms"]) > 0
    capture = {}
    fb = frame.frame_core(r["scene"], frame.init_state(r["scene"].num_draws, r["scene"].meshlet_visibility_count, DEV),
                          r["params"], r["cfg"], capture=capture)[0]
    tc, st = frame.debug_inputs(capture)
    for mode in ("meshlet", "draw", "depth"):
        card = shade.debug_visualize(fb, tc, st, mode).cpu()
        cpu_fb = type(fb)(depth=fb.depth.cpu(), vis=fb.vis.cpu())
        cpu = shade.debug_visualize(cpu_fb, {k: v.cpu() for k, v in tc.items()}, {"tri_k": st["tri_k"].cpu()}, mode)
        assert torch.equal(card, cpu), mode
    img = r["image"]
    assert torch.equal(hud.draw_hud(img, ["frame 1.23 ms"]).cpu(), hud.draw_hud(img.cpu(), ["frame 1.23 ms"]))


def _trace_inputs(tmp_path, case):
    """A BVH on the card and seeded rays aimed at its draws: "opaque" 2,000
    of the reference's PCG draws; "alpha" cooker.small_alpha_scene with its
    mask rows; "budget" the opaque scene walked 24 steps a ray."""
    g = cooker.cook_procedural(str(tmp_path))
    if case == "alpha":
        g, draws, mats, _, mips = cooker.small_alpha_scene(g)
        bvh = shadow.build_scene_rt(g, draws, mats, mips)[0]
        targets, dist = draws.position[draws.post_pass == 1], 8.0
    else:
        draws = cooker.synthesize_draws(g.meshes.count, draw_count=2000)
        bvh, targets, dist = shadow.build_scene_rt(g, draws)[0], draws.position, 25.0
    rng = np.random.default_rng(21)
    tg = targets[rng.integers(0, len(targets), 20000)] + rng.normal(scale=0.6, size=(20000, 3))
    o = tg + rng.normal(scale=dist, size=tg.shape)
    d = (tg - o) / np.linalg.norm(tg - o, axis=1, keepdims=True)
    return (bvh.to(DEV), torch.tensor(o, dtype=torch.float32, device=DEV),
            torch.tensor(d, dtype=torch.float32, device=DEV))


@pytest.mark.parametrize("case", ["opaque", "alpha", "budget"])
def test_trace_kernel_matches_plain(tmp_path, case):
    """trace_any_hit<false/true> (trace_cuda) against trace_plain on the
    same card tensors: every flag and every ray's step count (-1 where the
    budget ran out) equal; one launch counted; trace_any_hit takes the
    kernel; the same results with the rays taken in a seeded random order,
    on the card's grid and on one block (its warps refill many times)."""
    _need_cuda()
    bvh, o, d = _trace_inputs(tmp_path, case)
    alpha, steps = case == "alpha", 24 if case == "budget" else 1024
    name = "trace_alpha" if alpha else "trace"
    before = _build.LAUNCHES[name]
    occ, n = shadow.trace_cuda(bvh, o, d, max_steps=steps, alpha_test=alpha)
    assert _build.LAUNCHES[name] == before + 1
    assert torch.equal(shadow.trace_any_hit(bvh, o, d, max_steps=steps, alpha_test=alpha), occ)
    p_occ, p_n = shadow.trace_plain(bvh, o, d, max_steps=steps, alpha_test=alpha)
    assert torch.equal(occ, p_occ) and torch.equal(n, p_n)
    perm = torch.from_numpy(np.random.default_rng(22).permutation(len(o)).astype(np.int32)).to(DEV)
    for kw in (dict(order=perm), dict(order=perm, blocks=1)):
        got = shadow.trace_cuda(bvh, o, d, max_steps=steps, alpha_test=alpha, **kw)
        assert torch.equal(got[0], p_occ) and torch.equal(got[1], p_n), kw
    assert 0 < int(occ.sum()) < len(occ)
    if case == "budget":
        assert int((n == -1).sum()) > 100
    if alpha:
        assert bool((shadow.trace_plain(bvh, o, d)[0] & ~occ).any()), "the masks let some rays through"


def test_rt_frame_on_the_card_matches_cpu(tmp_path):
    """Two ray-traced 256x128 frames of the small scene on the card against
    the CPU: state, vis, depth and every traced flag exact; the shadow term
    and image within 2e-6 (exp2 and pow differ between the math
    libraries)."""
    _need_cuda()
    g = cooker.cook_procedural(str(tmp_path))
    draws = cooker.small_scene_draws(g.meshes.count)
    host_bvh = shadow.build_scene_rt(g, draws)[0]
    np_scene = scene.upload(g, draws)
    cfg = frame.FrameConfig(width=W, height=H, shadows=True, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    runs = []
    for device in (DEV, "cpu"):
        tds = scene.from_numpy(np_scene, device)
        state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, device)
        cap = {}
        for _ in range(2):
            image, fb, state, _ = frame.render_frame(tds, state, params, sp, cfg, bvh=host_bvh.to(device), capture=cap)
        runs.append((image.cpu(), fb.depth.cpu(), fb.vis.cpu(), state.draw_vis.cpu(), cap["shadow"].cpu(),
                     cap["trace"]["occluded"].cpu()))
    card, cpu = runs
    for k in (1, 2, 3, 5):
        assert torch.equal(card[k], cpu[k]), k
    assert float((card[4] - cpu[4]).abs().max()) <= 2e-6 and float((card[0] - cpu[0]).abs().max()) <= 2e-6
    assert bool((cpu[4] < 0.5).any()) and bool((cpu[4] > 0.99).any())
