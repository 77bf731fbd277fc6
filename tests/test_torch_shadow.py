"""The shadowed, animated textured frame of niagara_tpu_torch against the
reference: `shadow.shadow_blur`, and two chained 256x128 frames of the
small alpha scene (tests/test_torch_scene.py::alpha_parity_scene) with
sun-map shadows, against the reference's
render_frame(cfg.shadows=True, bloom=False, bvh=(sun frame, packed map,
shape)) (kernels in interpret mode).

Each frame moves the scene's last three draws (the near ring and the two
behind it) as bench.py's animated tail, updates the port's 256x256 sun map
on the tail's dirty band onto the static map of the other draws, splices
the band into the packed table (sunmap.pack_band) and hands the same table
to both frames, so the frames are compared on one map
(tests/test_torch_sunmap.py holds the maps to the reference's).

Exact: FrameState and every FrameStats field, each frame loss-free, the
tail's band partial and loss-free.  The visibility buffer and depth carry
the alpha frame's float notes of tests/test_torch_frame.py (FMA-contracted
planes: 10-11 winner flips at the double-sided ring's silhouette, each a
near tie or on an edge; limit 12).  The shadow term, computed by both from
the reference's depth: XLA's exp2 differs from torch's in the blur's
weights, by at most 2.4e-7 (limit 1e-6).  From each frame's own depth the
reconstructed positions move with the depth, and at shadow edges a PCF tap
changes side, which the blur spreads to its neighbours: outside the flips
the term differs by at most 0.038 and by more than 5e-4 at 1.28% of the
pixels (limits 0.05, 1.5%); 69% of the covered pixels are in some shadow
(term < 1).  The image, outside the flips: at most 3 pixels beyond the
alpha frame's 4.8e-3 (2 on a shadow edge, 1 where the shade-time alpha
discard decides the other way at a checker edge); each pixel's largest
channel error averages 1.45e-5 (limit 2e-5).  shadow_blur alone on seeded inputs: within 5e-7."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import shadow as jshadow
from niagara_tpu.ops import sunmap as jsm
from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import scene
from niagara_tpu_torch.ops import shadow, sunmap
from niagara_tpu_torch.render import camera, frame, textures
from test_torch_frame import _edge_flips
from test_torch_scene import CAPS, H, N_DRAWS, W, alpha_parity_scene

INVALID = 0x7FFFFFFF
MAP = 256
STATIC_N = N_DRAWS - 3
SUN_CAPS = dict(cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15)


def test_shadow_blur_matches_reference():
    rng = np.random.default_rng(3)
    term = np.where(rng.random((40, 60)) < 0.3, rng.random((40, 60)), 1.0).astype(np.float32)
    depth = np.where(rng.random((40, 60)) < 0.1, 0.0, rng.uniform(0.01, 0.5, (40, 60))).astype(np.float32)
    depth[10:20] = np.linspace(0.02, 0.03, 60, dtype=np.float32)  # a smooth slope the gradient predicts
    ref = np.asarray(jshadow.shadow_blur(jnp.asarray(term), jnp.asarray(depth), jnp.float32(0.1)))
    got = shadow.shadow_blur(torch.from_numpy(term), torch.from_numpy(depth), 0.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-7)
    assert np.abs(got - term).max() > 0.1, "the blur moves the term"


def _moved(ds, t):
    """The numpy scene with its tail moved as bench.py's animate_scene."""
    delta = np.array([np.sin(t), 0.0, 1.0 - np.cos(t)], np.float32) * np.float32(2.0)
    pos, xf = ds.draw_position.copy(), ds.draw_xform_row.copy()
    pos[STATIC_N:] += delta
    xf[STATIC_N:, 0:3] += delta
    return dataclasses.replace(ds, draw_position=pos, draw_xform_row=xf)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    ds, table = alpha_parity_scene(tmp_path_factory.mktemp("mesh"))
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=2, bloom=False, shadows=True, raster_interpret=True,
                              **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=2, bloom=False, shadows=True, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    jtable, ttable = jax.device_put(table), textures.to_device(table, "cpu")
    rest = types.SimpleNamespace(position=ds.draw_position)
    jsf, sf = jsm.fit_sun_to_draws(tsp.sun_direction, rest), sunmap.fit_sun_to_draws(tsp.sun_direction, rest, device="cpu")
    tds = scene.from_numpy(ds, "cpu")
    kw = dict(map_w=MAP, map_h=MAP, **SUN_CAPS)
    static, sdrop = sunmap.build_static_sun_map(tds, sf, batch=16, num_draws=STATIC_N, **kw)
    assert int(sdrop) == 0
    tail = tds.slice_draws(STATIC_N, N_DRAWS)
    win = sunmap.dirty_tile_rows(sf, tail.draw_position, tail.draw_mesh_row[:, 3] * tail.draw_scale, MAP,
                                 margin=4.0 + 2.0 * sunmap.map_texel_world(sf, MAP, MAP))
    a, b = win[0] * 8, (win[0] + win[1]) * 8
    packed_static = sunmap.pack_sun_map(static)
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for i in range(2):
        ds_i = _moved(ds, 0.3 * (i + 1))
        tds_i = scene.from_numpy(ds_i, "cpu")
        band, udrop = sunmap.update_sun_map(tds_i.slice_draws(STATIC_N, N_DRAWS), sf, static, None, row_window=win,
                                            **kw)
        packed = sunmap.pack_band(packed_static, band, a, MAP, row_above=static[a - 1] if a else None,
                                  row_below=static[b] if b < MAP else None)
        jpacked = jnp.asarray(packed.numpy())
        jimg, jfb, jstate, jstats = jframe.render_frame(ds_i, jstate, jp, jsp, jcfg, bvh=(jsf, jpacked, (MAP, MAP)),
                                                        textures=jtable)
        timg, tfb, tstate, tstats = frame.render_frame(tds_i, tstate, tp, tsp, tcfg, textures=ttable,
                                                       sun=(sf, packed, (MAP, MAP)))
        pass_kw = dict(width=W, height=H, packed=packed, map_shape=(MAP, MAP), blur=True)
        jterm = jsm.shadow_map_pass(jfb.depth, jsf, None, inverse_view_projection=jsp.inverse_view_projection,
                                    znear=jp.znear, **dict(pass_kw, packed=jpacked))
        ref_depth = torch.from_numpy(np.array(jfb.depth))
        term_same = sunmap.shadow_map_pass(ref_depth, sf, None, inverse_view_projection=tsp.inverse_view_projection,
                                           znear=tp.znear, **pass_kw)
        term_own = sunmap.shadow_map_pass(tfb.depth, sf, None, inverse_view_projection=tsp.inverse_view_projection,
                                          znear=tp.znear, **pass_kw)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()}, term=np.asarray(jterm))
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw,
                   stats=tstats.to_dict(), term_same=term_same.numpy(), term=term_own.numpy(), sun_drop=int(udrop),
                   window=win)
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_shadowed_frame_state_and_stats_exact(frames, i):
    ref, got = frames[i]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert got["stats"][k] == 0, k
    assert got["sun_drop"] == 0 and 0 < got["window"][1] < MAP // 8, "a partial dirty band, loss-free"


@pytest.mark.parametrize("i", [0, 1])
def test_shadowed_frame_images_match(frames, i):
    ref, got = frames[i]
    covered = ref["vis"] != INVALID
    flips = got["vis"] != ref["vis"]
    assert flips.sum() <= 12, f"{flips.sum()} vis ids differ"
    tie = np.abs(got["depth"] - ref["depth"]) <= 1.3e-4 * ref["depth"]
    _edge_flips(np.where(tie, ref["vis"], got["vis"]), ref["vis"])
    # the shadow term, at the reference's depth and at each frame's own
    shaded = covered & (ref["term"] < 1.0)
    assert 200 < shaded.sum() < covered.sum() and ref["term"].min() < 0.5, "the frame has shadows and light"
    np.testing.assert_allclose(got["term_same"], ref["term"], rtol=0, atol=1e-6)
    moved = np.abs(got["term"] - ref["term"])[~flips]
    assert moved.max() < 0.05 and (moved > 5e-4).mean() < 0.015, (moved.max(), (moved > 5e-4).mean())
    assert np.isfinite(got["image"]).all()
    err = np.abs(got["image"] - ref["image"]).max(axis=-1)[~flips]
    assert (err > 4.8e-3).sum() <= 3 and err.mean() < 2e-5, ((err > 4.8e-3).sum(), err.mean())
