"""The transmission layer of niagara_tpu_torch (post_passes=3) against the
JAX reference (niagara_tpu/render/frame.py:376-431, 592-629,
ops/shade.py:420-475; tests/test_transmission.py):

* the composite's blend on the reference's oracle inputs;
* the small glass scene (cooker.small_glass_scene: the small alpha scene
  with material 6's draws in the transmission class and materials 0-3
  normal-mapped; textures and opacity masks) at 256x128 over two chained
  frames, the port's second frame from the reference's first-frame state;
* post_passes=2 leaves the transmission draws unrendered, and the layer
  never touches the opaque depth/vis;
* a tiny .gltf with a KHR_materials_transmission material and a
  normalTexture, loaded and rendered by both packages.

Exact: FrameState and every FrameStats field.  The opaque buffers, the
transmission layer and the image carry the float differences of ROADMAP
queue C (XLA:CPU contracts the reference's a*b+c into FMAs); each test
states its limits beside this scene's numbers.

XLA:CPU segfaults writing the three-class frame's entry into its
persistent compilation cache (tests/test_transmission.py:30-39), so this
module runs with the cache off."""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import gltf as jgltf
from niagara_tpu.cooker import opacity as jopacity
from niagara_tpu.ops import shade as jshade
from niagara_tpu.render import frame as jframe
from niagara_tpu.render import textures as jtextures
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.cooker import gltf, opacity
from niagara_tpu_torch.ops import cullmath, shade
from niagara_tpu_torch.render import camera, frame, textures
from test_torch_scene import H, W

INVALID = 0x7FFFFFFF
# the glass scene at 256x128: frame 0's late pass takes every draw (62
# clusters, 1,263 triangles, 2,906 pairs); later frames need at most 46
# early clusters, 761 triangles and 1,728 pairs
CAPS = dict(cmd_capacity=1 << 6, cluster_capacity=1 << 8, candidate_capacity=1 << 8, pair_capacity=1 << 12,
            tri_capacity=1 << 11, late_cluster_capacity=1 << 7, late_tri_capacity=1 << 11, late_pair_capacity=1 << 12)


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache():
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _oracle():
    """The reference test's blend inputs (test_transmission.py:129-151)."""
    h, w = 8, 128
    depth = np.full((h, w), 0.5, np.float32)
    depth[:, :32] = 0.0
    valid = depth > 0.0
    g0 = np.tile(np.array([0.5, 0.3, 0.2, 0.0], np.float32), (h, w, 1))
    g1 = np.tile(np.array([0.5, 0.5, 0.4, 0.0], np.float32), (h, w, 1))
    g0t = np.tile(np.array([0.1, 0.2, 0.6, 0.0], np.float32), (h, w, 1))
    g1t = np.tile(np.array([0.3, 0.7, 0.1, 0.0], np.float32), (h, w, 1))
    deptht = np.zeros((h, w), np.float32)
    deptht[:, :80] = 0.7
    deptht[:, 80:] = 0.3
    return h, w, (g0, g1, depth, valid), (g0t, g1t, deptht, np.ones((h, w), bool))


def test_composite_blend_matches_reference():
    """In front: the mean of the two lit colours; behind: untouched; over
    the background: blended with black -- the port's composite against the
    reference's on the same planes, within the math libraries' last bits
    (pow, exp2: 2e-6; measured 1.2e-7), and against its own oracle."""
    h, w, base, trans = _oracle()
    kw = dict(camera_position=np.zeros(3, np.float32), sun_direction=np.float32([0, 1, 0]),
              inverse_view_projection=np.eye(4, dtype=np.float32), width=w, height=h)
    ref = np.asarray(jshade.composite(*base, transmission=trans, **{**kw, "inverse_view_projection": jnp.eye(4)}))
    t = [torch.from_numpy(a) for a in base]
    tt = tuple(torch.from_numpy(a) for a in trans)
    out = shade.composite(*t, transmission=tt, **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)

    plain = shade.composite(*t, **kw).numpy()
    np.testing.assert_array_equal(out[:, 80:], plain[:, 80:])
    lit = shade._lit_color(t[0], t[1], t[2], **kw)
    litt = shade._lit_color(tt[0], tt[1], tt[2], **kw)
    xy = torch.from_numpy(np.stack(np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)),
                                   axis=-1))
    deband = ((cullmath.gradient_noise(xy) * 2.0 - 1.0) * (0.5 / 255.0))[..., None]
    front = (cullmath.tonemap(lit * 0.5 + litt * 0.5) + deband).numpy()
    np.testing.assert_array_equal(out[:, 32:80], front[:, 32:80])
    bg = (cullmath.tonemap(torch.zeros_like(lit) * 0.5 + litt * 0.5) + deband).numpy()
    np.testing.assert_array_equal(out[:, :32], bg[:, :32])
    assert np.abs(out[:, :80] - plain[:, :80]).max(axis=-1).min() > 1e-2


def glass_parity_scene(cache_dir):
    """(numpy DeviceScene of the reference's upload, the reference's host
    texture table) of cooker.small_glass_scene's arrays."""
    g, draws, materials, masks, mips = cooker.small_glass_scene(cooker.cook_procedural(str(cache_dir)))
    table = jtextures.build_texture_table(mips=mips)
    return jscene.upload(g, draws, materials, masks, texture_table=table), table


def _reference_frame(ds, state, params, sp, textures, cfg):
    """The reference's render_frame for a frame without bloom or shadows
    (frame.py:615-700: frame_core, the layer's G-buffer from its own
    depth, the main G-buffer, composite with the transmission layer),
    returning the layer too: one program to compile instead of two."""
    assert not cfg.bloom and not cfg.shadows
    fb, _, _, new_state, stats, attrs, trans = jframe.frame_core(ds, state, params, cfg)
    ivp = sp.inverse_view_projection
    g0t, g1t, valid_t = jshade.gbuffer_from_attrs(trans["attrs"], trans["vis"] != INVALID, ds, textures=textures,
                                                  depth=trans["depth"], inverse_view_projection=ivp)
    g0, g1, valid = jshade.gbuffer_from_attrs(attrs, fb.vis != INVALID, ds, textures=textures, depth=fb.depth,
                                              inverse_view_projection=ivp)
    image = jshade.composite(g0, g1, fb.depth, valid, camera_position=sp.camera_position,
                             sun_direction=sp.sun_direction, inverse_view_projection=ivp, width=cfg.width,
                             height=cfg.height, transmission=(g0t, g1t, trans["depth"], valid_t))
    return image, fb, new_state, stats, trans


@pytest.fixture(scope="module")
def glass_frames(tmp_path_factory):
    ds, table = glass_parity_scene(tmp_path_factory.mktemp("mesh"))
    assert ds.texture_slots[1] and (ds.draw_post_pass == 2).sum() == 6
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=3, bloom=False, raster_interpret=True, **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=3, bloom=False, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    tds = scene.from_numpy(ds, "cpu")
    jtable, ttable = jax.device_put(table), textures.to_device(table, "cpu")
    reference = jax.jit(lambda s, st, p, spp, tex: _reference_frame(s, st, p, spp, tex, jcfg))
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for _ in range(2):
        jimg, jfb, jstate, jstats, layer = reference(ds, jstate, jp, jsp, jtable)
        capture = {}
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, textures=ttable, capture=capture)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   layer_depth=np.asarray(layer["depth"]), layer_vis=np.asarray(layer["vis"]),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw,
                   layer_depth=capture["layer"]["depth"].numpy(), layer_vis=capture["layer"]["vis"].numpy(),
                   stats=tstats.to_dict(), passes=capture["passes"])
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_glass_frame_state_and_stats_exact(glass_frames, i):
    ref, got = glass_frames[i]
    assert got["passes"] == ["early", "late", "glass"]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert got["stats"][k] == 0, k


@pytest.mark.parametrize("i", [0, 1])
def test_glass_layer_matches_reference(glass_frames, i):
    """The layer covers the same 3,808 pixels as the reference's, with ids
    in the third group's range, in front of the opaque surface at many of
    them.  The transmission class is double-sided, like the alpha class,
    so at its tubes' silhouettes a front and a back face meet on nearly
    edge-on depth planes, and the planes' FMA gaps decide the winner: 22
    pixels take the neighbouring triangle of the same meshlet (limit 24),
    each a near tie (depths within 1.6e-5 relative; limit 1.3e-4, the alpha
    frame's).  Depth elsewhere: max 5.04e-5 at one such silhouette pixel,
    two pixels above 1e-5, median relative 1.27e-6 (limits 1e-4, 2,
    3e-6)."""
    ref, got = glass_frames[i]
    covered = ref["layer_vis"] != INVALID
    np.testing.assert_array_equal(got["layer_vis"] != INVALID, covered)
    assert covered.sum() > 500
    lo = CAPS["tri_capacity"] + CAPS["late_tri_capacity"]
    assert (got["layer_vis"][covered] >= lo).all()
    np.testing.assert_array_equal(got["layer_depth"][~covered], 0.0)
    flips = got["layer_vis"] != ref["layer_vis"]
    assert flips.sum() <= 24, f"{flips.sum()} layer ids differ"
    err = np.abs(got["layer_depth"] - ref["layer_depth"])
    assert (err[flips] <= 1.3e-4 * ref["layer_depth"][flips]).all()
    same = covered & ~flips
    assert err[same].max() < 1e-4 and (err[same] > 1e-5).sum() <= 2
    assert np.median(err[same] / ref["layer_depth"][same]) < 3e-6
    assert (covered & (ref["layer_depth"] > ref["depth"])).sum() > 100


@pytest.mark.parametrize("i", [0, 1])
def test_glass_frame_images_match(glass_frames, i):
    """The opaque buffers within the alpha frame's limits of
    tests/test_torch_frame.py: 10 winner flips at the ring's silhouette
    (limit 12), depth elsewhere max 1.49e-5 with one pixel above 1e-5,
    median relative 2.76e-6 (limits 2e-5, 1, 3e-6).  The image: max
    5.73e-3, mean 3.76e-6 (limits 6e-3, 4e-6).  The largest differences
    sit on the alpha ring's one- and two-pixel slivers at its silhouette,
    where the normal map's screen-space derivatives difference depths on a
    nearly edge-on plane; the alpha frame, without normal maps, reaches
    4.68e-3."""
    ref, got = glass_frames[i]
    covered = ref["vis"] != INVALID
    assert 2000 < covered.sum() < covered.size
    flips = got["vis"] != ref["vis"]
    assert flips.sum() <= 12, f"{flips.sum()} vis ids differ"
    same = covered & ~flips
    err = np.abs(got["depth"][same] - ref["depth"][same])
    assert err.max() < 2e-5 and (err > 1e-5).sum() <= 1
    assert np.median(err / ref["depth"][same]) < 3e-6
    assert np.isfinite(got["image"]).all()
    np.testing.assert_allclose(got["image"][~flips], ref["image"][~flips], rtol=0, atol=6e-3)
    assert np.abs(got["image"] - ref["image"])[~flips].mean() < 4e-6


def _render_port(ds_np, table, post_passes, frames=2):
    cfg = frame.FrameConfig(width=W, height=H, post_passes=post_passes, bloom=False, **CAPS)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    tds = scene.from_numpy(ds_np, "cpu")
    tex = textures.to_device(table, "cpu")
    state = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    for _ in range(frames):
        image, fb, state, stats = frame.render_frame(tds, state, params, sp, cfg, textures=tex)
    return image.numpy(), fb.depth.numpy(), fb.vis.numpy(), stats.to_dict()


def test_post_passes_2_leaves_transmission_unrendered(tmp_path):
    """With post_passes=2 the class-2 draws are invisible: removing them
    changes neither depth nor image; with post_passes=3 the opaque depth
    and vis stay those of post_passes=2 (the layer has its own) while the
    image changes (test_transmission.py:89-123)."""
    g, draws, materials, masks, mips = cooker.small_glass_scene(cooker.cook_procedural(str(tmp_path)))
    table = jtextures.build_texture_table(mips=mips)
    img2, depth2, vis2, _ = _render_port(jscene.upload(g, draws, materials, masks, texture_table=table), table, 2)
    img3, depth3, vis3, _ = _render_port(jscene.upload(g, draws, materials, masks, texture_table=table), table, 3)
    keep = draws.post_pass != 2
    kept = jscene.Draws(**{k: getattr(draws, k)[keep] for k in vars(draws)})
    kept.meshlet_visibility_offset[:] = 0
    img_k, depth_k, _, _ = _render_port(jscene.upload(g, kept, materials, masks, texture_table=table), table, 2)
    np.testing.assert_array_equal(depth2, depth_k)
    np.testing.assert_array_equal(img2, img_k)
    np.testing.assert_array_equal(depth3, depth2)
    np.testing.assert_array_equal(vis3, vis2)
    assert (depth2 > 0).sum() > 2000
    assert np.abs(img3 - img2).max() > 1e-2


def _write_glass_gltf(tmp_path):
    """Two quads facing the camera: an opaque one 6 units ahead with a
    baseColorTexture and a normalTexture, and a KHR_materials_transmission
    one 4 units ahead covering its left half; DDS textures beside it."""
    from niagara_tpu_torch.cooker.synth_city import _write_dds_rgba_mips

    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    nrm = np.tile([0, 0, 1.0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint16)
    buf = verts.tobytes() + nrm.tobytes() + uv.tobytes() + tris.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(buf).decode(),
                     "byteLength": len(buf)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n} for o, n in ((0, 48), (48, 48), (96, 32),
                                                                                     (128, 12))],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3,
                                    "material": m}]} for m in (0, 1)],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}, "normalTexture": {"index": 1}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.5, 0.9, 1.0]},
             "extensions": {"KHR_materials_transmission": {"transmissionFactor": 0.8}}},
        ],
        "extensionsUsed": ["KHR_materials_transmission"],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": "albedo.png"}, {"uri": "normal.png"}],
        "nodes": [{"mesh": 0, "translation": [0, 0, -6], "scale": [2.5, 2.5, 1]},
                  {"mesh": 1, "translation": [-1.2, 0, -4]}],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    path = tmp_path / "glass.gltf"
    path.write_text(json.dumps(doc))
    yy, xx = np.mgrid[0:32, 0:32]
    albedo = np.zeros((32, 32, 4), np.uint8)
    albedo[..., :3] = np.where((((xx // 4) + (yy // 4)) % 2 == 0)[..., None], [220, 180, 60], [60, 90, 200])
    albedo[..., 3] = 255
    _write_dds_rgba_mips(str(tmp_path / "albedo.dds"), albedo)
    _write_dds_rgba_mips(str(tmp_path / "normal.dds"), cooker.synthesize_normal_map(32)[0])
    return str(path)


def test_gltf_transmission_and_normal_map_render_like_reference(tmp_path):
    """The loader puts the transmission material's draw in class 2 and the
    normalTexture in slot 1 in both packages; both render it with
    post_passes=3 over two frames: stats exact, vis exact, depth and image
    within the limits above."""
    path = _write_glass_gltf(tmp_path)
    sd, jsd = gltf.load_scene(path), jgltf.load_scene(path)
    np.testing.assert_array_equal(sd.draws.post_pass, jsd.draws.post_pass)
    np.testing.assert_array_equal(sd.materials["textures"], jsd.materials["textures"])
    assert list(sd.draws.post_pass) == [0, 2] and sd.materials["textures"][0, 1] >= 0
    mips, substituted = textures.load_texture_mips(sd.texture_paths, base_dir=str(tmp_path))
    assert not substituted
    jmips = jtextures.load_texture_mips(jsd.texture_paths, base_dir=str(tmp_path))
    assert all(np.array_equal(a, b) for m, jm in zip(mips, jmips) for a, b in zip(m, jm))
    assert opacity.bake_opacity(sd.geometry, sd.draws, sd.materials, mips) is None
    assert jopacity.bake_opacity(jsd.geometry, jsd.draws, jsd.materials, jmips) is None
    table = jtextures.build_texture_table(mips=jmips)
    ds = jscene.upload(jsd.geometry, jsd.draws, jsd.materials, None, texture_table=table)
    assert ds.texture_slots == (True, True, False, False)
    caps = dict(cmd_capacity=64, cluster_capacity=256, pair_capacity=1 << 12, tri_capacity=1 << 10,
                late_cluster_capacity=256, late_tri_capacity=1 << 10)
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=3, raster_interpret=True, **caps)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=3, **caps)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tds = scene.from_numpy(ds, "cpu")
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    ttable = textures.to_device(table, "cpu")
    for _ in range(2):
        jimg, jfb, jstate, jstats = jframe.render_frame(ds, jstate, jp, jsp, jcfg, textures=jax.device_put(table))
        capture = {}
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, textures=ttable, capture=capture)
        for k, v in vars(jax.device_get(jstats)).items():
            np.testing.assert_array_equal(tstats.to_dict()[k], np.asarray(v).astype(np.int64), err_msg=k)
        np.testing.assert_array_equal(tfb.vis.numpy(), np.asarray(jfb.vis))
        assert np.abs(tfb.depth.numpy() - np.asarray(jfb.depth)).max() < 2e-5
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=4.8e-3)
    layer = capture["layer"]["vis"] != INVALID
    assert int(layer.sum()) > 500 and int((tfb.vis != INVALID).sum()) > 2000
    # the blend shows where the glass quad lies in front
    plain = frame.render_frame(tds, tstate, tp, tsp, frame.FrameConfig(width=W, height=H, post_passes=2, **caps),
                               textures=ttable)[0]
    assert float((timg - plain).abs()[layer].max()) > 1e-2
