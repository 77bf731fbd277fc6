"""The whole two-pass frame of niagara_tpu_torch against the JAX
reference's render_frame (direct tile path, no bloom or shadows, kernels
in interpret mode), over two chained frames: the opaque frame
(post_passes=1) of the parity scene, and the textured, alpha-classed frame
(post_passes=2, textures, opacity masks) of its alpha form
(test_alpha_frame_*: limits stated there).  The port's second frame starts
from the reference's first-frame state (frame.state_from_numpy).

Exact: FrameState (draw visibility, visibility words) and every
FrameStats field.  The visibility buffer, depth and image carry the float
differences stated in tests/test_torch_setup.py and
tests/test_torch_raster.py: XLA:CPU contracts the reference's a*b+c into
FMAs (moving a few corners by one 1/256 snap step and the depth planes by
many ulps, since their coefficients cancel), and the reference's normals
pass through a 2-way bf16 split.  So a pixel whose center lies on a
triangle edge can fall on either side, and a nearly edge-on depth plane
(the near ring's tube silhouette) turns the coefficients' few-ulp
differences into a visible depth gap.  Each limit sits just above what
this scene shows, frame by frame: 1 pixel changes winner (limit 2, each on
a boundary between the two winners); depth elsewhere differs by at most
9.44e-5 at that one silhouette pixel and by under 1e-5 everywhere else
(limits 1e-4, and 1 pixel above 1e-5), median relative 2.35e-6 (limit
3e-6); the image by at most 3.59e-3, mean 1.41e-6 (limits 3.7e-3, 2e-6)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import scene
from niagara_tpu_torch.render import camera, frame, textures
from test_torch_scene import CAPS, H, W, alpha_parity_scene, parity_scene

INVALID = 0x7FFFFFFF


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    _, ds = parity_scene(tmp_path_factory.mktemp("mesh"))
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=1, bloom=False, raster_interpret=True, **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, bloom=False, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    tds = scene.from_numpy(ds, "cpu")
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for _ in range(2):
        jimg, jfb, jstate, jstats = jframe.render_frame(ds, jstate, jp, jsp, jcfg)
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv,
                   vis_words=vw, stats=tstats.to_dict())
        out.append((ref, got))
        # the next frame starts from the reference's state, carried across
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_frame_state_and_stats_exact(frames, i):
    ref, got = frames[i]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    assert got["vis_words"].dtype == ref["vis_words"].dtype == np.uint32
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    s = got["stats"]
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert s[k] == 0, k
    # frame 1 renders everything in its late pass (the early depth is
    # empty); frame 2's early pass re-renders it, its late pass finds
    # nothing new, and occluded draws turn invisible
    if i == 0:
        assert s["early_clusters"] == 0 and s["late_clusters"] > 0
    else:
        assert s["early_clusters"] > 0 and s["late_clusters"] == 0
        assert s["visible_draws"] < ref["draw_vis"].size


def _edge_flips(got_vis, ref_vis):
    """Pixels whose winner differs, each checked to sit on the boundary
    between the two winners (an 8-neighbour holds the other side's id):
    a pixel center within rounding of a triangle edge, covered on one side
    of the FMA difference and not on the other."""
    diff = np.argwhere(got_vis != ref_vis)
    for y, x in diff:
        ys, xs = slice(max(y - 1, 0), y + 2), slice(max(x - 1, 0), x + 2)
        assert (ref_vis[ys, xs] == got_vis[y, x]).any() or (got_vis[ys, xs] == ref_vis[y, x]).any(), (y, x)
    return got_vis != ref_vis


@pytest.mark.parametrize("i", [0, 1])
def test_frame_images_match(frames, i):
    ref, got = frames[i]
    covered = ref["vis"] != INVALID
    assert 2000 < covered.sum() < covered.size, "objects and background both on screen"
    flips = _edge_flips(got["vis"], ref["vis"])
    assert flips.sum() <= 2, f"{flips.sum()} vis ids differ"
    same = covered & ~flips
    np.testing.assert_array_equal(got["depth"][~covered & ~flips], 0.0)
    d_ref, d_got = ref["depth"][same], got["depth"][same]
    err = np.abs(d_got - d_ref)
    assert err.max() < 1e-4 and (err > 1e-5).sum() <= 1
    assert np.median(err / d_ref) < 3e-6
    assert np.isfinite(got["image"]).all()
    np.testing.assert_allclose(got["image"][~flips], ref["image"][~flips], rtol=0, atol=3.7e-3)
    assert np.abs(got["image"] - ref["image"])[~flips].mean() < 2e-6


@pytest.fixture(scope="module")
def alpha_frames(tmp_path_factory):
    ds, table = alpha_parity_scene(tmp_path_factory.mktemp("mesh"))
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=2, bloom=False, raster_interpret=True, **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=2, bloom=False, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    tds = scene.from_numpy(ds, "cpu")
    jtable, ttable = jax.device_put(table), textures.to_device(table, "cpu")
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for _ in range(2):
        jimg, jfb, jstate, jstats = jframe.render_frame(ds, jstate, jp, jsp, jcfg, textures=jtable)
        # the same frame with the masks cleared (idu 0: no raster-time test)
        nomask = dataclasses.replace(tds, meshlet_alpha=torch.zeros_like(tds.meshlet_alpha))
        _, nfb, _, _ = frame.render_frame(nomask, tstate, tp, tsp, tcfg, textures=ttable)
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, textures=ttable)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv,
                   vis_words=vw, stats=tstats.to_dict(), nomask_vis=nfb.vis.numpy())
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_alpha_frame_state_and_stats_exact(alpha_frames, i):
    ref, got = alpha_frames[i]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    s = got["stats"]
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert s[k] == 0, k
    # the alpha class is culled in every late pass, so frame 2's late pass
    # still carries clusters
    assert s["late_clusters"] > 0


@pytest.mark.parametrize("i", [0, 1])
def test_alpha_frame_images_match(alpha_frames, i):
    """The textured alpha frame: the opaque frame's limits, re-measured on
    this scene.  The ring is in the alpha class, so its back faces render
    too (post classes are double-sided), and at its silhouette a back and a
    front face meet on nearly edge-on depth planes: there the FMA gaps of
    the planes (ROADMAP queue C) decide which face wins.  So the winner
    changes at 9 pixels, each a near tie: the two frames' depths there agree
    within 1.3e-4 relative (worst 1.25e-4), or the pixel sits on an edge
    between the two winners.  Depth elsewhere: max 1.49e-5, one pixel above
    1e-5, median relative 2.39e-6 (limits 2e-5, 1, 3e-6); the image: max
    4.68e-3, mean 2.73e-6 (limits 4.8e-3, 3e-6).  The masks discard at
    raster time: with them cleared, 2,191 pixels change winner."""
    ref, got = alpha_frames[i]
    covered = ref["vis"] != INVALID
    assert 2000 < covered.sum() < covered.size, "objects and background both on screen"
    discarded = (got["nomask_vis"] != INVALID) & (got["vis"] != got["nomask_vis"])
    assert discarded.sum() > 1000
    flips = got["vis"] != ref["vis"]
    assert flips.sum() <= 12, f"{flips.sum()} vis ids differ"
    tie = np.abs(got["depth"] - ref["depth"]) <= 1.3e-4 * ref["depth"]
    _edge_flips(np.where(tie, ref["vis"], got["vis"]), ref["vis"])
    same = covered & ~flips
    np.testing.assert_array_equal(got["depth"][~covered & ~flips], 0.0)
    d_ref, d_got = ref["depth"][same], got["depth"][same]
    err = np.abs(d_got - d_ref)
    assert err.max() < 2e-5 and (err > 1e-5).sum() <= 1
    assert np.median(err / d_ref) < 3e-6
    assert np.isfinite(got["image"]).all()
    np.testing.assert_allclose(got["image"][~flips], ref["image"][~flips], rtol=0, atol=4.8e-3)
    assert np.abs(got["image"] - ref["image"])[~flips].mean() < 3e-6
