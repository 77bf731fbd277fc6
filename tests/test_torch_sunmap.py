"""The sun map of niagara_tpu_torch (ops/sunmap.py) against the reference's
(niagara_tpu/ops/sunmap.py, the raster kernel in interpret mode), on two
scenes, each package cooking and uploading its own: the plane-and-occluder
scene of tests/test_sunmap.py (a 20x20 ground plane, a 2x2 occluder 2
units above it) and the small alpha scene (cooker.small_alpha_scene: 48
torus draws, the near ring and every eighth draw in the alpha class, with
opacity masks), mapped at 256x256 with the default sun.

Exact: sun_cull (texel and camera LOD, with a draw range), the task
commands (every field, also at a capacity that drops draws), the cluster
cull, compact_setup's counts, drops, boxes and validity, pair emission
with a row window (the out-of-window drop included), dirty_tile_rows, and
the plane scene's map.  Floats carry the FMA note of ROADMAP queue C:
XLA:CPU computes the sun transform `world @ rows.T` as a contracted dot,
which moves a few corner coordinates (at most 2 ulps; limit 2 ulps on at
most 5% of them); compact_setup given the same corners is bit for bit the
reference's.  Through the nearly edge-on depth planes of the torus's
coarse LOD those ulps grow: on each package's own chain the records differ
by at most 1.88e-5 of a column's range (limit 3e-5), and the alpha scene's
map keeps every covered texel, with depth off by at most 2.34e-4 at 11.0%
of them and a median of 0 (limits 3e-4, 12%, 0).  The reference's static
build runs jitted: XLA fuses it and contracts every plane evaluation,
moving 98% of the covered texels, by at most 1.94e-3 and a median of
1.74e-5 (limits 2.1e-3, 2e-5), with the same texels covered.

Inside the port, exact: a band equals the matching rows of the full
update, a forced band too small for the tail equals them as well and
reports its lost pairs, batched equals single, pack_band equals
pack_sun_map of the full update, raster_plain on a band equals the
matching rows of the full raster; the packed resolve equals the unpacked
one within 1e-6 (the reference's limit: at the border the two weigh equal
taps differently)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import cook as jcook
from niagara_tpu.cooker import opacity as jopacity
from niagara_tpu.cooker import synth as jsynth
from niagara_tpu.ops import cull as jcull
from niagara_tpu.ops import raster as jraster
from niagara_tpu.ops import raster_tile as jrt
from niagara_tpu.ops import sunmap as jsm
from niagara_tpu.render import presets as jpresets
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.cooker import opacity
from niagara_tpu_torch.ops import cull, raster, raster_tile, sunmap
from niagara_tpu_torch.render import presets
from test_torch_scene import N_DRAWS, RING

MAP = 256
TX, TY = MAP // 128, MAP // 8
CAPS = dict(cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15)
SUN = np.array([1.0, 1.0, 1.0], np.float32) / np.sqrt(np.float32(3.0))
STATIC_N = N_DRAWS - 3  # the tail: the near ring and the two draws behind it
# the alpha scene's maps (module docstring): depth error, share of covered
# texels moved beyond 1e-6
ALPHA_MAP_ERR, ALPHA_MAP_MOVED = 3e-4, 0.12
# the reference's static build runs jitted: XLA fuses the whole render and
# contracts it into FMAs, moving nearly every texel (max, median)
JIT_MAP_ERR, JIT_MAP_MEDIAN = 2.1e-3, 2e-5

PLANE = """
v -10 0 -10
v  10 0 -10
v  10 0  10
v -10 0  10
vn 0 1 0
f 1//1 3//1 2//1
f 1//1 4//1 3//1
"""
OCCLUDER = PLANE.replace("10", "1")
OCCLUDER_UV = """
v -1 0 -1
v  1 0 -1
v  1 0  1
v -1 0  1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
f 1/1/1 3/3/1 2/2/1
f 1/1/1 4/4/1 3/3/1
"""


def _plane_draws(synth, mesh_count, post=(0, 0)):
    d = synth(mesh_count, draw_count=2)
    d.mesh_index[:] = [0, 1]
    d.position[:] = np.array([[0, 0, 0], [0, 2, 0]], np.float32)
    d.scale[:] = 1.0
    d.orientation[:] = np.array([0, 0, 0, 1], np.float32)
    d.post_pass[:] = post
    d.material_index[:] = 0
    return d


def _obj(tmp, name, text):
    path = tmp / name
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Both packages' plane scenes, their 256x256 maps under a slanted sun."""
    tmp = tmp_path_factory.mktemp("plane")
    paths = [_obj(tmp, "plane.obj", PLANE), _obj(tmp, "occ.obj", OCCLUDER)]
    jg = jcook.cook_obj_meshes(paths, build_lods=False)
    tg = cooker.cook_obj_meshes(paths, build_lods=False)
    jds = jax.device_put(jscene.upload(jg, _plane_draws(jsynth.synthesize_draws, jg.meshes.count)))
    tds = scene.from_numpy(scene.upload(tg, _plane_draws(cooker.synthesize_draws, tg.meshes.count)), "cpu")
    sun = np.array([0.2, 1.0, 0.1], np.float32)
    sun /= np.linalg.norm(sun)
    jsf = jsm.fit_sun(sun, [-12, -1, -12], [12, 3, 12])
    tsf = sunmap.fit_sun(sun, [-12, -1, -12], [12, 3, 12], device="cpu")
    kw = dict(map_w=MAP, map_h=MAP, cmd_capacity=64, cluster_capacity=64, tri_capacity=1 << 10,
              pair_capacity=1 << 12)
    jmap, _, jdrop = jsm.render_sun_map(jds, jsf, camera_position=jnp.zeros(3), lod_target=jnp.float32(1e-6),
                                        lod_enabled=jnp.int32(0), interpret=True, **kw)
    tmap, tdrop = sunmap.render_sun_map(tds, tsf, camera_position=np.zeros(3), lod_target=1e-6, lod_enabled=0, **kw)
    return dict(ref=np.asarray(jmap), ref_drop=int(jdrop), got=tmap, drop=int(tdrop), sf=tsf, kw=kw, scene=tds)


def _alpha_scenes(tmp):
    """(reference DeviceScene, port DeviceScene) of the small alpha scene,
    each package cooking the procedural OBJ and making the scene its own
    way (the reference's synth/opacity/upload, cooker.small_alpha_scene)."""
    path = cooker.procedural_obj(str(tmp))
    jg = jcook.cook_obj_meshes([path])
    jsynth.synthesize_planar_uvs(jg, tiles=cooker.synth.SMALL_UV_TILES)
    draws = cooker.small_scene_draws(jg.meshes.count)
    materials, mips, mat_idx, post = jsynth.synthesize_materials(draws.count)
    mat_idx[RING], post[RING] = len(mips) - 1, 1
    draws.material_index[:] = mat_idx
    draws.post_pass[:] = post
    jds = jscene.upload(jg, draws, materials, jopacity.bake_opacity(jg, draws, materials, mips))
    g, tdraws, tmats, masks, _ = cooker.small_alpha_scene(cooker.cook_obj_meshes([path]))
    return jds, scene.from_numpy(scene.upload(g, tdraws, tmats, masks), "cpu"), tdraws


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def alpha(tmp_path_factory):
    """The small alpha scene through both packages' sun-map stages, the
    reference's full map and its batched static build."""
    jnp_ds, tds, draws = _alpha_scenes(tmp_path_factory.mktemp("alpha"))
    jds = jax.device_put(jnp_ds)
    jsf, tsf = jsm.fit_sun_to_draws(SUN, draws), sunmap.fit_sun_to_draws(SUN, draws, device="cpu")
    tw = sunmap.map_texel_world(tsf, MAP, MAP)
    ref = {}
    ref["emit"], ref["lod"] = jsm.sun_cull(jds, jsf, None, None, 1, texel_world=tw,
                                           draw_range=(jnp.int32(4), jnp.int32(46)))
    cmds = jcull.build_task_commands(jds, ref["emit"], ref["lod"], jnp.ones(N_DRAWS, jnp.int32), max_groups=8,
                                     capacity=CAPS["cmd_capacity"])
    ref["cmds"] = cmds
    ref["ccull"] = jsm.sun_cluster_cull(jds, jsf, cmds, CAPS["cluster_capacity"])
    tc = jsm.transform_sun(jds, jsf, *ref["ccull"][:3], cmds, MAP, MAP)
    ref["setup"] = jraster.compact_setup(tc, MAP, MAP, 1e-3, CAPS["tri_capacity"])
    ref["tc"] = tc
    ref["setup_same"] = jraster.compact_setup(tc, MAP, MAP, 1e-3, CAPS["tri_capacity"])
    kw = dict(map_w=MAP, map_h=MAP, texel_world=tw, **CAPS)
    ref["map"], _, ref["map_drop"] = jsm.render_sun_map(jds, jsf, interpret=True, **kw)
    ref["static"], ref["static_drop"] = jsm.build_static_sun_map(jds, jsf, batch=16, num_draws=STATIC_N,
                                                                 interpret=True, **kw)
    ref = jax.tree_util.tree_map(_np, ref)
    return dict(ref=ref, jds=jds, jsf=jsf, scene=tds, sf=tsf, texel=tw, kw=kw, draws=draws)


def _port_chain(a, draw_range=(4, 46)):
    tds, tsf = a["scene"], a["sf"]
    emit, lod = sunmap.sun_cull(tds, tsf, texel_world=a["texel"], draw_range=draw_range)
    cmds = cull.build_task_commands(tds, emit, lod, torch.ones(N_DRAWS, dtype=torch.int32),
                                    capacity=CAPS["cmd_capacity"])
    ccull = sunmap.sun_cluster_cull(tds, tsf, cmds, CAPS["cluster_capacity"])
    tc = sunmap.transform_sun(tds, tsf, *ccull[:3], cmds, MAP, MAP)
    return emit, lod, cmds, ccull, raster.compact_setup(tc, MAP, MAP, 1e-3, CAPS["tri_capacity"])


@pytest.mark.parametrize("lod_rule", ["texel", "camera"])
def test_sun_cull_matches_reference(alpha, lod_rule):
    if lod_rule == "texel":
        emit, lod = _port_chain(alpha)[:2]
        ref_emit, ref_lod = alpha["ref"]["emit"], alpha["ref"]["lod"]
    else:
        cam = np.array([0.0, 1.0, 2.0], np.float32)
        ref_emit, ref_lod = jsm.sun_cull(alpha["jds"], alpha["jsf"], jnp.asarray(cam), jnp.float32(0.01), 1)
        emit, lod = sunmap.sun_cull(alpha["scene"], alpha["sf"], cam, np.float32(0.01), 1)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(ref_emit))
    np.testing.assert_array_equal(lod.numpy(), np.asarray(ref_lod))
    assert 0 < emit.sum() <= N_DRAWS
    # one texel here is coarser than every LOD's error: the coarsest LOD
    picked = np.unique(lod.numpy()[emit.numpy()])
    assert list(picked) == [15] if lod_rule == "texel" else len(picked) > 1, picked


@pytest.mark.parametrize("capacity", [CAPS["cmd_capacity"], 24])
def test_task_commands_match_reference(alpha, capacity):
    """Every field of every slot, and at a capacity of 24 draws whole
    drop (the reference's TASK_WGLIMIT rule)."""
    emit, lod, *_ = _port_chain(alpha)
    dvb = np.zeros(N_DRAWS, np.int32)
    dvb[::3] = 1
    got = cull.build_task_commands(alpha["scene"], emit, lod, torch.from_numpy(dvb), capacity=capacity)
    ref = jcull.build_task_commands(alpha["jds"], jnp.asarray(emit.numpy()), jnp.asarray(lod.numpy()),
                                    jnp.asarray(dvb), max_groups=8, capacity=capacity)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name)), err_msg=f.name)
    assert (int(got.dropped) > 0) == (capacity == 24) and int(got.count) > 0


def test_cluster_cull_matches_reference(alpha):
    _, _, cmds, ccull, _ = _port_chain(alpha)
    ref = alpha["ref"]
    for f in dataclasses.fields(cmds):
        np.testing.assert_array_equal(getattr(cmds, f.name).numpy(), getattr(ref["cmds"], f.name), err_msg=f.name)
    for got, want in zip(ccull, ref["ccull"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(ccull[2]) > N_DRAWS // 2


def test_compact_setup_matches_reference(alpha):
    """On each package's own transform_sun output: counts, drops, boxes and
    validity exact, records close (the corners differ by the ulps of the
    sun transform).  On the reference's transform_sun output fed to both:
    every record bit for bit."""
    a, ref = alpha, alpha["ref"]
    _, _, cmds, ccull, st = _port_chain(a)
    n = int(st["count"])
    assert n == int(ref["setup"]["count"]) > 500 and int(st["dropped"]) == int(ref["setup"]["dropped"]) == 0
    for k in ("valid", "x0", "y0", "x1", "y1", "tri_k", "tri_t"):
        np.testing.assert_array_equal(st[k].numpy()[:n], ref["setup"][k][:n], err_msg=k)
    got, want = st["rec"].numpy()[:n], ref["setup"]["rec48"][:n]
    rel = np.abs(got - want).max(axis=0) / np.maximum(np.abs(want).max(axis=0), 1e-30)
    assert rel.max() < 3e-5, rel

    tc = sunmap.transform_sun(a["scene"], a["sf"], *ccull[:3], cmds, MAP, MAP)
    k = int(ccull[2])
    for key in ("hx", "hy", "zw"):
        ulps = np.abs(tc[key].numpy()[:k].view(np.int32).astype(np.int64)
                      - ref["tc"][key][:k].view(np.int32).astype(np.int64))
        assert ulps.max() <= 2 and (ulps > 0).mean() < 0.05, key
    same = {key: torch.from_numpy(np.array(v)) for key, v in ref["tc"].items() if key != "alpha"}
    st = raster.compact_setup(dict(same, alpha=a["scene"].meshlet_alpha), MAP, MAP, 1e-3, CAPS["tri_capacity"])
    n = int(st["count"])
    got, want = st["rec"].numpy()[:n], ref["setup_same"]["rec48"][:n].copy()
    want[:, 13] = np.arange(n)  # the compacted index
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 46:48], 0.0)
    # the mask row rides on every cluster, post class or not (raster.py:465-472)
    opaque = got[:, 45] == 0
    assert opaque.any() and (got[opaque, 54] > 0).any()


@pytest.mark.parametrize("window", [(8, 10), (0, TY)])
def test_emit_pairs_row_window_matches_reference(alpha, window):
    st = _port_chain(alpha)[4]
    jst = dict(valid=jnp.asarray(st["valid"].numpy()), **{k: jnp.asarray(st[k].numpy()) for k in ("x0", "y0", "x1", "y1")})
    ref = jrt.emit_pairs(jst, tiles_x=TX, tiles_y=TY, pair_capacity=CAPS["pair_capacity"], row_window=window)
    got = raster_tile.emit_pairs(st, tiles_x=TX, tiles_y=TY, pair_capacity=CAPS["pair_capacity"], row_window=window)
    for name, r in zip(("pair_tri", "tile_start", "pair_count", "dropped", "drop_vec", "demand_vec"), ref):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(r).astype(np.int64), err_msg=name)
    assert got["tile_start"].shape[0] == window[1] * TX + 1 and int(got["pair_count"]) > 0
    assert (int(got["drop_vec"][5]) > 0) == (window[1] < TY), "pairs outside the band count as dropped"


def _map_close(got, ref, max_err, moved, median=0.0):
    """The same covered texels; depth within max_err, at most a `moved`
    share of the covered texels beyond 1e-6 and a median within `median`."""
    got = _np(got)
    covered = ref > 0
    np.testing.assert_array_equal(got > 0, covered)
    err = np.abs(got - ref)[covered]
    stats = (err.max(), (err > 1e-6).mean(), np.median(err))
    assert err.max() < max_err and stats[1] <= moved and stats[2] <= median, stats


def test_plane_map_matches_reference(plane):
    assert plane["drop"] == plane["ref_drop"] == 0
    assert (plane["ref"] > 0).sum() > 20_000
    np.testing.assert_array_equal(plane["got"].numpy(), plane["ref"])


def test_render_sun_map_matches_reference(alpha):
    ref = alpha["ref"]
    got, drop = sunmap.render_sun_map(alpha["scene"], alpha["sf"], **alpha["kw"])
    assert int(drop) == int(ref["map_drop"]) == 0
    assert 1_000 < (ref["map"] > 0).sum() < MAP * MAP
    _map_close(got, ref["map"], ALPHA_MAP_ERR, ALPHA_MAP_MOVED)
    # a band: the reference's full rows (its own test holds its band to them)
    band, bdrop = sunmap.render_sun_map(alpha["scene"], alpha["sf"], row_window=(8, 12), **alpha["kw"])
    assert int(bdrop) > 0, "casters outside the band are reported"
    _map_close(band, ref["map"][64:160], ALPHA_MAP_ERR, 1.0)
    np.testing.assert_array_equal(band.numpy(), got.numpy()[64:160])


def test_static_map_matches_reference(alpha):
    """Batched static build (3 batches of 16 draws, the tail left out)
    against the reference's, and against one unbatched render."""
    ref = alpha["ref"]
    got, drop = sunmap.build_static_sun_map(alpha["scene"], alpha["sf"], batch=16, num_draws=STATIC_N,
                                            **alpha["kw"])
    assert int(drop) == int(ref["static_drop"]) == 0
    _map_close(got, ref["static"], JIT_MAP_ERR, 1.0, JIT_MAP_MEDIAN)
    single, _ = sunmap.render_sun_map(alpha["scene"], alpha["sf"], draw_range=(0, STATIC_N), **alpha["kw"])
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert (ref["static"] > 0).sum() < (ref["map"] > 0).sum(), "the tail casts"


def _moved_tail(a, t):
    """The tail's draws moved as bench.py's animate_tail moves them."""
    tail = a["scene"].slice_draws(STATIC_N, N_DRAWS)
    delta = torch.tensor([np.sin(t), 0.0, 1.0 - np.cos(t)], dtype=torch.float32) * 2.0
    xf = tail.draw_xform_row.clone()
    xf[:, 0:3] += delta
    return dataclasses.replace(tail, draw_position=tail.draw_position + delta, draw_xform_row=xf)


def test_band_update_matches_full_update(alpha):
    """The dirty-band update (tests/test_sunmap.py:327-383): the band
    equals the full update's rows, the full update's other rows are the
    static map's, pack_band equals pack_sun_map of the full update; a
    forced band too small for the tail still equals its rows and reports
    the tail's pairs outside it."""
    a, kw = alpha, dict(alpha["kw"])
    static, _ = sunmap.build_static_sun_map(a["scene"], a["sf"], batch=16, num_draws=STATIC_N, **kw)
    packed_static = sunmap.pack_sun_map(static)
    tail0 = a["scene"].slice_draws(STATIC_N, N_DRAWS)
    radius = tail0.draw_mesh_row[:, 3] * tail0.draw_scale
    win = sunmap.dirty_tile_rows(a["sf"], tail0.draw_position, radius, MAP, margin=4.0 + 2.0 * a["texel"])
    assert 0 < win[0] and win[0] + win[1] < TY, win
    for t in (0.3, 0.6):
        tail = _moved_tail(a, t)
        full, fdrop = sunmap.update_sun_map(tail, a["sf"], static, None, **kw)
        band, bdrop = sunmap.update_sun_map(tail, a["sf"], static, None, row_window=win, **kw)
        assert int(fdrop) == int(bdrop) == 0
        lo, hi = win[0] * 8, (win[0] + win[1]) * 8
        np.testing.assert_array_equal(band.numpy(), full.numpy()[lo:hi])
        np.testing.assert_array_equal(full.numpy()[:lo], static.numpy()[:lo])
        np.testing.assert_array_equal(full.numpy()[hi:], static.numpy()[hi:])
        assert not torch.equal(full, static)
        packed = sunmap.pack_band(packed_static, band, lo, MAP, row_above=static[lo - 1], row_below=static[hi])
        np.testing.assert_array_equal(packed.numpy(), sunmap.pack_sun_map(full).numpy())
        forced = (win[0] + 1, 2)
        fband, fdrop = sunmap.update_sun_map(tail, a["sf"], static, None, row_window=forced, **kw)
        np.testing.assert_array_equal(fband.numpy(), full.numpy()[forced[0] * 8:(forced[0] + 2) * 8])
        assert int(fdrop) > 0


@pytest.mark.parametrize("margin", [0.0, 4.5])
def test_dirty_tile_rows_matches_reference(alpha, margin):
    draws = alpha["draws"]
    pos = draws.position[STATIC_N:]
    rad = np.full(pos.shape[0], 1.3, np.float32)
    got = sunmap.dirty_tile_rows(alpha["sf"], torch.from_numpy(pos), torch.from_numpy(rad), MAP, margin=margin)
    assert got == jsm.dirty_tile_rows(alpha["jsf"], pos, rad, MAP, margin=margin)
    assert got == sunmap.dirty_tile_rows(alpha["sf"], pos, 1.3, MAP, margin=margin)


def test_raster_plain_band_equals_full_rows(alpha):
    """raster_plain with a band start: coverage at full-grid rows, so the
    band equals the full raster's rows, over a seeded carried depth/vis."""
    st = _port_chain(alpha)[4]
    rng = np.random.default_rng(11)
    depth = torch.from_numpy(np.where(rng.random((MAP, MAP)) < 0.3, rng.uniform(0, 1, (MAP, MAP)), 0).astype(np.float32))
    vis = torch.from_numpy(rng.integers(0, 1 << 20, (MAP, MAP)).astype(np.int32))
    full = raster_tile.emit_pairs(st, tiles_x=TX, tiles_y=TY, pair_capacity=CAPS["pair_capacity"])
    fd, fv = raster_tile.raster_plain(full["tile_start"], full["pair_tri"], st["rec"], 0, depth, vis, TX,
                                      alpha_test=True)
    drawn = np.nonzero((fv != vis).any(dim=1).numpy())[0] // 8  # tile rows the records reach
    for row0, n in ((0, drawn.min() + 2), (drawn.min() + 1, drawn.max() - drawn.min())):
        pairs = raster_tile.emit_pairs(st, tiles_x=TX, tiles_y=TY, pair_capacity=CAPS["pair_capacity"],
                                       row_window=(row0, n))
        rows = slice(row0 * 8, (row0 + n) * 8)
        bd, bv = raster_tile.raster_plain(pairs["tile_start"], pairs["pair_tri"], st["rec"], 0, depth[rows],
                                          vis[rows], TX, alpha_test=True, band_row0=row0)
        np.testing.assert_array_equal(bd.numpy(), fd.numpy()[rows])
        np.testing.assert_array_equal(bv.numpy(), fv.numpy()[rows])
        assert not torch.equal(bv, vis[rows])


def test_packed_resolve_matches_unpacked(plane):
    """sample_shadow_packed against sample_shadow (tests/test_sunmap.py:207),
    points past the map's border included, and through shadow_map_pass."""
    smap, sf = plane["got"], plane["sf"]
    packed = sunmap.pack_sun_map(smap)
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-20, 20, 512), rng.uniform(-0.5, 2.5, 512), rng.uniform(-20, 20, 512)], axis=1)
    pts = torch.from_numpy(pts.astype(np.float32))
    a = sunmap.sample_shadow(smap, sf, pts)
    b = sunmap.sample_shadow_packed(packed, MAP, MAP, sf, pts)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert (a < 0.25).any() and (a > 0.75).any()
    depth = torch.full((32, 32), 0.5)
    kw = dict(inverse_view_projection=np.eye(4, dtype=np.float32), width=32, height=32, scale=1)
    t1 = sunmap.shadow_map_pass(depth, sf, smap, **kw)
    t2 = sunmap.shadow_map_pass(depth, sf, None, packed=packed, map_shape=(MAP, MAP), **kw)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-6)


def test_occluder_shadows_its_footprint(plane):
    """Under the occluder (its footprint along the slanted sun) the ground
    is shadowed, open ground lit (tests/test_sunmap.py:53)."""
    sun = np.array([0.2, 1.0, 0.1], np.float32)
    foot = np.array([0.0, 2.0, 0.0]) - 2.0 * sun / sun[1]  # the occluder's centre cast along the sun
    pts = torch.tensor(np.array([foot, foot + [0.5, 0, 0.5], [5.0, 0, 5.0], [-8.0, 0, 3.0]], np.float32))
    term = sunmap.sample_shadow(plane["got"], plane["sf"], pts).numpy()
    assert term[0] < 0.25 and term[1] < 0.25 and term[2] > 0.75 and term[3] > 0.75, term


def test_cutout_caster_holed_shadow(tmp_path):
    """An alpha-class occluder whose left half (u < 0.5) is cut out casts a
    holed shadow (tests/test_sunmap.py:262): the raster's mask test runs
    on the sun map."""
    paths = [_obj(tmp_path, "plane.obj", PLANE), _obj(tmp_path, "occ.obj", OCCLUDER_UV)]
    g = cooker.cook_obj_meshes(paths, build_lods=False)
    draws = _plane_draws(cooker.synthesize_draws, g.meshes.count, post=(0, 1))
    tex = np.zeros((64, 64, 4), np.uint8)
    tex[:, 32:, :] = 255
    materials = {"diffuse": np.ones((1, 4), np.float32), "specular": np.ones((1, 4), np.float32),
                 "emissive": np.zeros((1, 3), np.float32), "textures": np.array([[0, -1, -1, -1]], np.int32)}
    masks = opacity.bake_opacity(g, draws, materials, [[tex]])
    ds = scene.from_numpy(scene.upload(g, copy.deepcopy(draws), materials, masks), "cpu")
    assert ds.has_alpha_masks
    sf = sunmap.fit_sun(np.array([0.0, 1.0, 0.0], np.float32), [-12, -1, -12], [12, 3, 12], device="cpu")
    smap, drop = sunmap.render_sun_map(ds, sf, camera_position=np.zeros(3), lod_target=1e-6, lod_enabled=0,
                                       map_w=MAP, map_h=MAP, cmd_capacity=64, cluster_capacity=64,
                                       tri_capacity=1 << 10, pair_capacity=1 << 12)
    assert int(drop) == 0
    pts = torch.tensor([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [5.0, 0.0, 5.0]])
    term = sunmap.sample_shadow(smap, sf, pts).numpy()
    assert term[0] > 0.75 and term[1] < 0.25 and term[2] > 0.75, term


@pytest.mark.parametrize("anim_n", [0, 3, 20_000])
def test_sunmap_update_capacities_match_reference(anim_n):
    """The reference's update budgets, the triangle and pair budgets
    raised for the torus (presets.py) but never above the static build's."""
    sun_caps = dict(cmd_capacity=1 << 16, cluster_capacity=1 << 16, tri_capacity=1 << 19, pair_capacity=1280 * 1024)
    ours, ref = presets.sunmap_update_capacities(anim_n, sun_caps), jpresets.sunmap_update_capacities(anim_n, sun_caps)
    raised = {"tri_capacity", "pair_capacity"} if anim_n else set()
    assert set(ours) == set(ref) and all(ours[k] == ref[k] for k in ref if k not in raised)
    assert all(ref[k] < ours[k] <= sun_caps[k] for k in raised)
