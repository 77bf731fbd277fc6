"""The staged configurations of niagara_tpu_torch (render/presets.py
settings_for and frame_overrides) and its single-pass frame
(FrameConfig.occlusion_two_pass=False, configs 0 and 1) against the JAX
reference (niagara_tpu/render/presets.py:26-53, render/frame.py:281-290,
561-581; tests/test_presets.py), on the reference test's blob scene: 16
draws of a 9x9 sphere within 12 units, 256x128, two chained frames, the
port's second frame from the reference's first-frame state.

Exact: the tables, FrameState, every FrameStats field and the visibility
buffer.  Depth and image carry the FMA differences of ROADMAP queue C:
depth within 5e-6 absolute, the image within 2e-6 (measured at most
2.58e-6 and 4.2e-7 on both configs).
A single-pass frame renders class 0 only, as the reference's does, and
configs 1 and 2 give the same depth (the reference's contract)."""

import dataclasses

import jax
import numpy as np
import pytest

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import cook as jcook
from niagara_tpu.cooker.synth import synthesize_draws
from niagara_tpu.render import camera as jcamera
from niagara_tpu.render import frame as jframe
from niagara_tpu.render import presets as jpresets
from niagara_tpu_torch import scene
from niagara_tpu_torch.render import camera, frame, presets

W, H = 256, 128
INVALID = 0x7FFFFFFF
# config 0 renders every draw at LOD 0 in one pass: 15 draws, 9 clusters
# after the cluster frustum test, 161 triangles, 404 pairs
CAPS = dict(cmd_capacity=1 << 6, cluster_capacity=1 << 7, candidate_capacity=1 << 7, pair_capacity=1 << 11,
            tri_capacity=1 << 10, late_cluster_capacity=1 << 6, late_tri_capacity=1 << 9, late_pair_capacity=1 << 10)


@pytest.mark.parametrize("config", range(6))
def test_presets_match_reference(config):
    base = camera.RenderSettings(draw_distance=50.0, debug_lod_step=1)
    ours = presets.settings_for(config, base)
    ref = jpresets.settings_for(config, jcamera.RenderSettings(draw_distance=50.0, debug_lod_step=1))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(presets.settings_for(config)) == dataclasses.asdict(jpresets.settings_for(config))
    assert presets.frame_overrides(config) == jpresets.frame_overrides(config)
    # every override names a field of the port's FrameConfig
    frame.FrameConfig(**{k: v for k, v in presets.frame_overrides(config).items()})
    assert presets.frame_overrides(config) is not presets.frame_overrides(config)


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """The reference test's blob scene (test_presets.py:44-66), with draw 5
    moved to the alpha class so that a single-pass frame has a class-1
    draw to leave out."""
    path = tmp_path_factory.mktemp("presets") / "blob.obj"
    lines, n = [], 9
    for j in range(n):
        for i in range(n):
            th, ph = np.pi * (j + 0.5) / n, 2 * np.pi * i / n
            lines.append(f"v {np.sin(th)*np.cos(ph):.5f} {np.cos(th):.5f} {np.sin(th)*np.sin(ph):.5f}")
    for j in range(n - 1):
        for i in range(n):
            a, b = j * n + i + 1, j * n + (i + 1) % n + 1
            lines += [f"f {a} {b} {a + n}", f"f {b} {b + n} {a + n}"]
    path.write_text("\n".join(lines) + "\n")
    g = jcook.cook_obj_meshes([str(path)])
    draws = synthesize_draws(g.meshes.count, draw_count=16, scene_radius=12.0)
    draws.post_pass[5] = 1
    return jscene.upload(g, draws)


def _frames(ds, config, post_passes=1):
    jcfg = jframe.FrameConfig(width=W, height=H, bloom=False, raster_interpret=True,
                              **{**CAPS, "post_passes": post_passes, **jpresets.frame_overrides(config)})
    tcfg = frame.FrameConfig(width=W, height=H, bloom=False,
                             **{**CAPS, "post_passes": post_passes, **presets.frame_overrides(config)})
    jp, jsp = jframe.make_frame_inputs(jcamera.Camera(), jpresets.settings_for(config), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), presets.settings_for(config), tcfg)
    tds = scene.from_numpy(ds, "cpu")
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for _ in range(2):
        jimg, jfb, jstate, jstats = jframe.render_frame(ds, jstate, jp, jsp, jcfg)
        capture = {}
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, capture=capture)
        ref = dict(depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis), draw_vis=np.asarray(jstate.draw_vis),
                   vis_words=np.asarray(jstate.vis_words), image=np.asarray(jimg),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw, image=timg.numpy(),
                   stats=tstats.to_dict(), passes=capture["passes"])
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.fixture(scope="module")
def single_pass(blob):
    return {config: _frames(blob, config) for config in (0, 1)}


@pytest.mark.parametrize("config,i", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_single_pass_frame_matches_reference(single_pass, config, i):
    ref, got = single_pass[config][i]
    assert got["passes"] == ["early"]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], np.asarray(v).astype(np.int64), err_msg=k)
    s = got["stats"]
    assert s["late_commands"] == s["late_clusters"] == s["candidates"] == 0
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert s[k] == 0, k
    np.testing.assert_array_equal(got["vis"], ref["vis"])
    assert (ref["vis"] != INVALID).sum() > 500
    assert np.abs(got["depth"] - ref["depth"]).max() < 5e-6
    np.testing.assert_allclose(got["image"], ref["image"], rtol=0, atol=2e-6)


def test_config0_renders_every_draw_at_lod0(single_pass):
    """Config 0: every class-0 draw emitted in the one pass (no culling),
    loss-free; the carried visibility words stay as they came in, and every
    draw, the alpha-class one too, keeps the all-ones visibility the pass
    starts from.  Config 1 culls draws out of view."""
    _, got = single_pass[0][1]
    assert got["stats"]["early_commands"] == 15 and got["stats"]["visible_draws"] == 15
    assert (got["vis_words"] == 0).all() and (got["draw_vis"] == 1).all()
    _, got1 = single_pass[1][1]
    assert got1["stats"]["early_commands"] < 15 and got1["draw_vis"][5] == 1


def test_config1_and_config2_depth_identical(blob, single_pass):
    """Occlusion culling removes only what loses the depth test: the
    two-pass config 2 converges to config 1's depth (test_presets.py:91)."""
    cfg = frame.FrameConfig(width=W, height=H, bloom=False, **CAPS, **presets.frame_overrides(2))
    params, sp = frame.make_frame_inputs(camera.Camera(), presets.settings_for(2), cfg)
    tds = scene.from_numpy(blob, "cpu")
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    for _ in range(2):
        _, fb, state, stats = frame.render_frame(tds, state, params, sp, cfg)
    assert all(int(stats.to_dict()[k]) == 0 for k in ("cmd_dropped", "cluster_dropped", "tri_dropped"))
    np.testing.assert_array_equal(fb.depth.numpy(), single_pass[1][1][1]["depth"])


def test_single_pass_leaves_post_classes_out(blob, single_pass):
    """A single-pass frame renders class 0 only, also with post_passes=2
    (as the reference's, frame.py:284-292): the alpha-class draw changes
    nothing against config 1's frames."""
    cfg = frame.FrameConfig(width=W, height=H, bloom=False, **{**CAPS, "post_passes": 2, **presets.frame_overrides(1)})
    params, sp = frame.make_frame_inputs(camera.Camera(), presets.settings_for(1), cfg)
    tds = scene.from_numpy(blob, "cpu")
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    for i in range(2):
        _, fb, state, _ = frame.render_frame(tds, state, params, sp, cfg)
        ref, got = single_pass[1][i]
        np.testing.assert_array_equal(fb.depth.numpy(), got["depth"])
        np.testing.assert_array_equal(fb.vis.numpy(), ref["vis"])
