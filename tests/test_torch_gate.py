"""The animated tail (niagara_tpu_torch/bench.py), the stage spans
(utils/profiling.py StageTimer) and the kernel-vs-plain gate
(render/parity.py, chip_smoke.py's "gate" phase), on the CPU at 256x128
with presets.small_capacities().

* The animated step (bench.SunTail.update: move the tail, render its
  dirty band of a 256x256 sun map, pack_band; bench.animate_scene;
  render_frame) on the small alpha scene against the same sequence built
  from the reference's functions as bench.py:325-347 chains them (the
  kernels in interpret mode), over two frames from a cold state, both
  sides on the port's static map.  Exact: FrameState, every FrameStats
  field, the tail's motion, the window, loss-free updates.  The band's
  depth carries the FMA note of tests/test_torch_sunmap.py: on the same
  static map it differs by at most 5.96e-8 at 1.07% and 1.48% of the
  covered texels (limits 1e-6, 3%), the same texels covered.  The
  visibility buffer and image carry tests/test_torch_shadow.py's limits:
  at most 12 winner flips, each on an edge (10 seen); outside them at
  most 3 pixels beyond 4.8e-3 (2 seen) and a mean largest-channel error
  under 2e-5 (8.1e-6 seen).
* StageTimer: frames with a timer equal frames without one bit for bit
  (the sun-mapped animated step, the ray-traced, the glass and the
  single-pass frame), with the stage names of each path, and each
  column summing to the frame's own ms within 5%.
* The gate: kernel_parity_check refuses a CPU device; with the kernel
  wrappers pointed at their plain versions the small scenes' replays
  (the opaque and the alpha frame with their G-buffers, a band of the
  alpha frame's late pass) pass on the CPU, and a wrapper that flips one
  bit of one word of its output is caught in the replay of its instance:
  setup (the alpha and the opaque frame's), raster (over the grid, and
  over the band with and without the alpha test), shade, the G-buffer
  (the opaque frame's untextured and the alpha frame's textured one,
  through the whole gate), bloom_down, bloom_up, the tail, bloom_x2, the
  trace, a cull pass (the early and the late pass's) and the pyramid.
"""

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import raster_tile as jraster_tile
from niagara_tpu.ops import sunmap as jsm
from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import bench, cooker, scene
from niagara_tpu_torch.ops import bloom, cull, pyramid, raster_tile, setup, shade, shadow, sunmap
from niagara_tpu_torch.render import camera, frame, parity, presets, textures
from niagara_tpu_torch.utils.profiling import StageTimer, stage_table
from test_torch_frame import _edge_flips
from test_torch_scene import CAPS, H, N_DRAWS, W, alpha_parity_scene

INVALID = 0x7FFFFFFF
MAP = 256
STATIC_N = N_DRAWS - 3
SUN_CAPS = dict(cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15)
FRAME_FIELDS = ("image", "depth", "vis")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The frames here run many small ops; under the parallel test run's
    other workers torch's intra-op threads only wait on each other (as
    tests/test_torch_rt_shadow.py found), so they run on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _janimate(sc, t, lo=0):
    """bench.py's animate_tail (lo=0) and animate_scene (lo=static_n) on
    the reference's scene (bench.py:184-193, 325-332)."""
    delta = jnp.stack([jnp.sin(t), jnp.zeros_like(t), 1.0 - jnp.cos(t)]) * 2.0
    return dataclasses.replace(sc, draw_position=sc.draw_position.at[lo:].add(delta),
                               draw_xform_row=sc.draw_xform_row.at[lo:, 0:3].add(delta))


@pytest.fixture(scope="module")
def animated(tmp_path_factory):
    ds, table = alpha_parity_scene(tmp_path_factory.mktemp("mesh"))
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=2, bloom=False, shadows=True, raster_interpret=True,
                              **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=2, bloom=False, shadows=True, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    jtable, ttable = jax.device_put(table), textures.to_device(table, "cpu")
    rest = types.SimpleNamespace(position=ds.draw_position)
    jsf, sf = jsm.fit_sun_to_draws(tsp.sun_direction, rest), sunmap.fit_sun_to_draws(tsp.sun_direction, rest, device="cpu")
    tds, jds = scene.from_numpy(ds, "cpu"), jax.device_put(ds)
    texel = sunmap.map_texel_world(sf, MAP, MAP)
    static, sdrop = sunmap.build_static_sun_map(tds, sf, map_w=MAP, map_h=MAP, texel_world=texel, batch=16,
                                                num_draws=STATIC_N, **SUN_CAPS)
    assert int(sdrop) == 0
    tail = bench.sun_tail(tds, sf, static, STATIC_N, MAP, texel, SUN_CAPS)
    a, b = tail.window[0] * 8, (tail.window[0] + tail.window[1]) * 8
    jstatic = jnp.asarray(static.numpy())
    jtiles, jpacked_static = jraster_tile.image_to_tiles(jstatic, MAP, MAP), jsm.pack_sun_map(jstatic)
    jtail = jds.slice_draws(STATIC_N, N_DRAWS)
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for i in range(2):
        t = 0.3 * (i + 1)
        packed, udrop = tail.update(t)
        moved = bench.animate_scene(tds, STATIC_N, t)
        timg, tfb, tstate, tstats = frame.render_frame(moved, tstate, tp, tsp, tcfg, textures=ttable,
                                                       sun=(sf, packed, (MAP, MAP)))
        jt = jnp.float32(t)
        jband, _, jdrop = jsm.update_sun_map(_janimate(jtail, jt), jsf, jtiles, None, map_w=MAP, map_h=MAP,
                                             texel_world=texel, row_window=tail.window, interpret=True, **tail.caps)
        jpacked = jsm.pack_band(jpacked_static, jband, a, MAP, row_above=jstatic[a - 1] if a else None,
                                row_below=jstatic[b] if b < MAP else None)
        jmoved = _janimate(jds, jt, STATIC_N)
        jimg, jfb, jstate, jstats = jframe.render_frame(jmoved, jstate, jp, jsp, jcfg, bvh=(jsf, jpacked, (MAP, MAP)),
                                                        textures=jtable)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()},
                   band=np.asarray(jband), packed=np.asarray(jpacked), drop=int(jdrop),
                   position=np.asarray(jmoved.draw_position), xform=np.asarray(jmoved.draw_xform_row))
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw,
                   stats=tstats.to_dict(), packed=packed.numpy(), drop=int(udrop),
                   band=packed.numpy().reshape(MAP, MAP, 4)[a:b, :, 0], position=moved.draw_position.numpy(),
                   xform=moved.draw_xform_row.numpy(), window=tail.window, static=static.numpy()[a:b])
        out.append((ref, got))
        # frame 2 from the same state on both sides, as tests/test_torch_shadow.py
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_bench_animated_step_state_stats_and_tail_exact(animated, i):
    ref, got = animated[i]
    np.testing.assert_array_equal(got["position"], ref["position"])
    np.testing.assert_array_equal(got["xform"], ref["xform"])
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert got["stats"][k] == 0, k
    assert got["drop"] == ref["drop"] == 0 and 0 < got["window"][1] < MAP // 8, "a partial band, loss-free"


@pytest.mark.parametrize("i", [0, 1])
def test_bench_animated_step_band_and_image_match(animated, i):
    ref, got = animated[i]
    covered = (ref["band"] > 0) | (got["band"] > 0)
    np.testing.assert_array_equal(ref["band"] > 0, got["band"] > 0)
    moved = np.abs(got["band"] - ref["band"])
    assert (got["band"] != got["static"]).any(), "the tail's casters land in the band"
    assert moved.max() <= 1e-6 and (moved > 0)[covered].mean() < 0.03, (moved.max(), (moved > 0)[covered].mean())
    flips = got["vis"] != ref["vis"]
    assert flips.sum() <= 12, f"{flips.sum()} vis ids differ"
    tie = np.abs(got["depth"] - ref["depth"]) <= 1.3e-4 * ref["depth"]
    _edge_flips(np.where(tie, ref["vis"], got["vis"]), ref["vis"])
    assert np.isfinite(got["image"]).all()
    err = np.abs(got["image"] - ref["image"]).max(axis=-1)[~flips]
    assert (err > 4.8e-3).sum() <= 3 and err.mean() < 2e-5, ((err > 4.8e-3).sum(), err.mean())


# ---- StageTimer ----

def test_stage_timer_columns_telescope():
    timer = StageTimer("cpu")
    for _ in range(2):
        timer.begin()
        for name in ("a", "b", "a"):
            time.sleep(0.002)
            timer.mark(name)
    frames = timer.resolve()
    assert [[r[0] for r in f["stages"]] for f in frames] == [["a", "b", "a"]] * 2
    for f in frames:
        assert all(r[1] == r[2] > 0 for r in f["stages"]), "on the CPU both columns are the host clock"
        assert sum(r[1] for r in f["stages"]) == pytest.approx(f["device_ms"], rel=1e-9)
    table = stage_table(frames)
    assert list(table["stages"]) == ["a", "b"]
    assert table["stages"]["a"]["host_ms"] == pytest.approx(
        sum(r[2] for f in frames for r in f["stages"] if r[0] == "a") / 2)
    assert table["host_ms"] == pytest.approx(sum(f["host_ms"] for f in frames) / 2)


STAGES = {
    "early": ["early draw cull", "early cluster cull", "early setup", "early emit+sort+raster"],
    "late": ["pyramid", "late cull", "late setup+raster"],
    "tail": ["shade", "G-buffer", "bloom"],
}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    g = cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))
    ga, da, mats, masks, mips = cooker.small_alpha_scene(g)
    table = textures.build_texture_table(mips)
    return types.SimpleNamespace(g=g, ga=ga, da=da, mats=mats, mips=mips, table=textures.to_device(table, "cpu"),
                                 scene=scene.from_numpy(scene.upload(ga, da, mats, masks, texture_table=table), "cpu"))


def _path(small, kind):
    """(step(state, stages) -> frame outputs, initial state, expected stage
    names) of one frame kind on the small scene."""
    sc, tex = small.scene, small.table
    if kind == "glass":
        g, d, mats, masks, mips = cooker.small_glass_scene(small.g)
        table = textures.build_texture_table(mips)
        sc, tex = scene.from_numpy(scene.upload(g, d, mats, masks, texture_table=table), "cpu"), \
            textures.to_device(table, "cpu")
    over = dict(post_passes=3) if kind == "glass" else dict(post_passes=2)
    if kind == "rt":
        over.update(shadows=True)
    if kind == "sun":
        over.update(shadows=True)
    if kind == "single":
        over.update(presets.frame_overrides(1), post_passes=1)
    cfg = frame.FrameConfig(width=W, height=H, **over, **CAPS)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    names = STAGES["early"] + (STAGES["late"] if kind != "single" else []) + STAGES["tail"]
    if kind == "glass":  # the layer's pass, and its G-buffer before the main one
        names[names.index("shade"):names.index("G-buffer")] = ["layer setup+raster", "shade", "layer G-buffer"]
    kw = dict(textures=tex)
    if kind == "rt":
        kw["bvh"] = shadow.build_scene_rt(small.ga, small.da)[0]
        names += ["rt rays+trace", "rt fill+blur"]
    names.append("composite")
    if kind != "sun":
        def step(state, stages):
            return frame.render_frame(sc, state, params, sp, cfg, stages=stages, **kw)
    else:
        sf = sunmap.fit_sun_to_draws(sp.sun_direction, small.da, device="cpu")
        texel = sunmap.map_texel_world(sf, MAP, MAP)
        static, _ = sunmap.build_static_sun_map(sc, sf, map_w=MAP, map_h=MAP, texel_world=texel, batch=16,
                                                num_draws=STATIC_N, **SUN_CAPS)
        tail = bench.sun_tail(sc, sf, static, STATIC_N, MAP, texel, SUN_CAPS)
        names = ["tail move", "sun cull", "sun setup", "sun raster", "pack_band"] + names[:-1] + \
            ["sun-map resolve+blur", "composite"]

        def step(state, stages):
            packed, _ = tail.update(0.6, stages)
            return frame.render_frame(bench.animate_scene(sc, STATIC_N, 0.6), state, params, sp, cfg,
                                      sun=(sf, packed, (MAP, MAP)), stages=stages, **kw)
    return step, frame.init_state(sc.num_draws, sc.meshlet_visibility_count, "cpu"), names


@pytest.mark.parametrize("kind", ["sun", "rt", "glass", "single"])
def test_stage_timer_frames_bit_for_bit(small, kind):
    step, state, names = _path(small, kind)
    plain = step(state, None)
    timer = StageTimer("cpu")
    t0 = time.perf_counter()
    timer.begin()
    timed = step(state, timer)
    frame_ms = (time.perf_counter() - t0) * 1e3
    for name, x, y in zip(FRAME_FIELDS, (plain[0], plain[1].depth, plain[1].vis), (timed[0], timed[1].depth,
                                                                                   timed[1].vis)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
    assert torch.equal(plain[2].draw_vis, timed[2].draw_vis) and torch.equal(plain[2].vis_words, timed[2].vis_words)
    s0, s1 = plain[3].to_dict(), timed[3].to_dict()
    assert all(np.array_equal(s0[k], s1[k]) for k in s0)
    (f,) = timer.resolve()
    assert [r[0] for r in f["stages"]] == names
    for col in (1, 2):
        assert abs(sum(r[col] for r in f["stages"]) / frame_ms - 1) <= 0.05


# ---- the gate ----

def _flip(t):
    """t with the lowest bit of its first word flipped (a contiguous copy:
    the chain's level 0 comes from the extract's channel-last view)."""
    t = t.clone(memory_format=torch.contiguous_format)
    if t.dtype == torch.bool:
        t.view(-1)[0] = ~t.view(-1)[0]
    elif t.dtype == torch.float32:
        t.view(-1).view(torch.int32)[0] ^= 1
    else:
        t.view(-1)[0] ^= 1
    return t


def _plain_trace(flip_blocks=None):
    """trace_plain in trace_cuda's place, the kernel's scheduling (order,
    blocks) dropped; the flags flipped on the calls with `blocks` equal to
    flip_blocks (None: none)."""
    def fake(*a, order=None, blocks=0, **kw):
        occ, steps = shadow.trace_plain(*a, **kw)[:2]
        return (_flip(occ) if blocks == flip_blocks else occ), steps
    return fake


def _plain_gbuffer(textured=None):
    """gbuffer_plain in gbuffer_cuda's place, with the kernel's count of
    shaded pixels; one bit of g0 flipped on the untextured (textured
    False) or the textured calls (True; None: none)."""
    def fake(attrs, valid, sc, tex=None, **kw):
        g0, g1, out = shade.gbuffer_plain(attrs, valid, sc, tex, **kw)
        if textured is not None and (tex is not None) == textured:
            g0 = _flip(g0)
        return g0, g1, out, out.sum().reshape(1)
    return fake


@pytest.fixture
def plain_kernels(monkeypatch):
    """Every kernel wrapper the gate replays pointed at its plain version
    (the wrappers raise on a CPU tensor)."""
    monkeypatch.setattr(setup, "setup_cuda", setup.setup_plain)
    monkeypatch.setattr(raster_tile, "raster_cuda", raster_tile.raster_plain)
    monkeypatch.setattr(raster_tile, "shade_cuda", raster_tile.shade_plain)
    monkeypatch.setattr(shade, "gbuffer_cuda", _plain_gbuffer())
    monkeypatch.setattr(bloom, "down2_cuda", bloom._down2)
    monkeypatch.setattr(bloom, "up2_add_cuda", bloom.up2_add_plain)
    monkeypatch.setattr(bloom, "tail_cuda", bloom.tail_plain)
    monkeypatch.setattr(bloom, "bilinear_x2_cuda", lambda s, oh, ow: bloom._bilinear_x2(s, oh, ow).permute(1, 2, 0))
    monkeypatch.setattr(shadow, "trace_cuda", _plain_trace())
    monkeypatch.setattr(cull, "cull_pass_cuda", cull.cull_pass_plain)
    monkeypatch.setattr(pyramid, "pyramid_cuda", pyramid.build_pyramid_plain)
    return monkeypatch


def test_kernel_parity_check_refuses_the_cpu(small):
    with pytest.raises(RuntimeError, match="nothing to compare"):
        parity.kernel_parity_check(small.g, "cpu")


def test_gate_replays_pass_with_plain_wrappers(small, plain_kernels):
    out = parity.replay_small_scene(small.g, "cpu")
    assert out["setup_records_live"] > 0 and out["covered_px"] > 100
    assert out["calls"] == {"cull": 4, "pyramid": 2, "setup": 2, "raster": 3, "shade": 2, "gbuffer": 2,
                            "setup_alpha": 2, "raster_alpha": 1, "raster_window": 1, "raster_alpha_window": 1}
    assert out["bloom_levels"] == 2 * bloom.bloom_levels(W, H) - 1
    assert 0 < out["occluded_rays"] < out["rays"] == 2 * (W // 2) * (H // 2) // 2


@pytest.fixture(scope="module")
def captured(small):
    """One captured small alpha frame (its second, from a cold state), the
    rays of its ray-traced shadow pass with the alpha test, and one
    captured small opaque frame (post_passes=1, the same way)."""
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, **CAPS)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(small.scene.num_draws, small.scene.meshlet_visibility_count, "cpu")
    cap = {}
    for _ in range(2):
        _, fb, state, _ = frame.render_frame(small.scene, state, params, sp, cfg, textures=small.table, capture=cap)
    bvh = shadow.build_scene_rt(small.ga, small.da, small.mats, small.mips)[0]
    tcap = {}
    shadow.shadow_pass(fb.depth, bvh, sun_direction=sp.sun_direction, inverse_view_projection=sp.inverse_view_projection,
                       width=W, height=H, quality=1, capture=tcap)
    opaque = scene.from_numpy(scene.upload(small.g, cooker.small_scene_draws(small.g.meshes.count)), "cpu")
    ocfg = frame.FrameConfig(width=W, height=H, **CAPS)
    ostate, ocap = frame.init_state(opaque.num_draws, opaque.meshlet_visibility_count, "cpu"), {}
    for _ in range(2):
        ostate = frame.render_frame(opaque, ostate, params, sp, ocfg, capture=ocap)[2]
    return types.SimpleNamespace(cap=cap, params=params, cfg=cfg, bvh=bvh, trace=tcap["trace"], opaque=opaque,
                                 ocap=ocap, ocfg=ocfg)


def _flip_raster(band=False, alpha=None):
    """raster_plain with one bit of its outputs flipped on the calls given
    a band start (`band`) and, unless None, that alpha_test."""
    def fake(*a, **kw):
        out = raster_tile.raster_plain(*a, **kw)
        hit = (kw.get("band_row0") is not None) == band and alpha in (None, kw.get("alpha_test", False))
        return tuple(_flip(x) for x in out) if hit else out
    return fake


def _flip_cull(out, is_late, late=False):
    """A cull pass's outputs with one bit flipped: the first group's
    x-ordered draw ids (early pass), or the visibility words (`late`: the
    late pass's)."""
    if is_late == late:
        key = "new_vis_words" if late else "groups"
        out = dict(out, **{key: _flip(out[key]) if late else [dict(out["groups"][0], draw_id=_flip(
            out["groups"][0]["draw_id"]))] + out["groups"][1:]})
    return out


FLIPS = {
    "setup": (setup, "setup_cuda", lambda *a: dict(setup.setup_plain(*a), rec=_flip(setup.setup_plain(*a)["rec"]))),
    "raster": (raster_tile, "raster_cuda", _flip_raster()),
    "shade": (raster_tile, "shade_cuda", lambda *a: _flip(raster_tile.shade_plain(*a))),
    "gbuffer": (shade, "gbuffer_cuda", _plain_gbuffer(textured=False)),
    "gbuffer textured": (shade, "gbuffer_cuda", _plain_gbuffer(textured=True)),
    "bloom_down": (bloom, "down2_cuda", lambda s: _flip(bloom._down2(s))),
    "bloom": (bloom, "up2_add_cuda", lambda s, m: _flip(bloom.up2_add_plain(s, m))),
    "bloom_x2": (bloom, "bilinear_x2_cuda",
                 lambda s, oh, ow: _flip(bloom._bilinear_x2(s, oh, ow).permute(1, 2, 0))),
    # one bit of one intermediate level of the tail (the second down level)
    "bloom_tail": (bloom, "tail_cuda", lambda s, n: [_flip(x) if i == 1 else x
                                                     for i, x in enumerate(bloom.tail_plain(s, n))]),
    "trace": (shadow, "trace_cuda", _plain_trace(flip_blocks=0)),
    "cull": (cull, "cull_pass_cuda", lambda *a, **kw: _flip_cull(cull.cull_pass_plain(*a, **kw), kw["late"])),
    "pyramid": (pyramid, "pyramid_cuda", lambda *a: _flip(pyramid.build_pyramid_plain(*a))),
    "trace_one_block": (shadow, "trace_cuda", _plain_trace(flip_blocks=1)),
}
# the kernel each flip is caught in, and the replay that catches it: the
# alpha frame's, the opaque frame's (setup_kernel<false>), the band's (each
# raster instance with band_row0) or the whole gate's (the G-buffers)
CAUGHT = {"setup": ("setup", "setup_alpha early"), "setup opaque": ("setup", "setup early"),
          "raster": ("raster", "raster early"), "raster_window": ("raster_window", "raster_window band"),
          "raster_alpha_window": ("raster_alpha_window", "raster_alpha_window band"),
          "shade": ("shade", "shade"), "gbuffer": ("gbuffer", "gbuffer"),
          "gbuffer textured": ("gbuffer textured", "gbuffer"), "bloom_down": ("bloom_down", "bloom_down"),
          "bloom": ("bloom", "bloom_up"), "bloom_tail": ("bloom_tail", "bloom_tail"),
          "bloom_x2": ("bloom_x2", "bloom_x2"),
          "trace": ("trace", "trace_alpha"),
          "cull": ("cull", "cull early"), "cull late": ("cull late", "cull late"), "pyramid": ("pyramid", "pyramid"),
          "trace_one_block": ("trace_one_block", "trace_alpha on one block")}
FLIPS.update({"cull late": (cull, "cull_pass_cuda",
                             lambda *a, **kw: _flip_cull(cull.cull_pass_plain(*a, **kw), kw["late"], late=True))})
FLIPS.update(raster_window=(raster_tile, "raster_cuda", _flip_raster(band=True)),
             raster_alpha_window=(raster_tile, "raster_cuda", _flip_raster(band=True, alpha=True)))


@pytest.mark.parametrize("which", list(CAUGHT))
def test_gate_flags_one_flipped_bit(small, captured, plain_kernels, which):
    flip, kernel = CAUGHT[which]
    mod, name, fake = FLIPS[flip]
    plain_kernels.setattr(mod, name, fake)
    with pytest.raises(parity.ParityError, match=f"^{kernel}"):
        if which.startswith("bloom"):
            parity.replay_bloom(captured.cap["g0"], W, H)
        elif which.startswith("trace"):
            parity.replay_trace(captured.bvh, captured.trace)
        elif which.startswith("gbuffer"):
            parity.replay_small_scene(small.g, "cpu")
        elif which == "setup opaque":
            parity.replay_frame(captured.ocap, captured.opaque, captured.params, captured.ocfg)
        elif which.endswith("window"):
            row0 = H // 8 // 4
            parity.replay_band(parity.band_args(captured.cap["setup_out"][-1], captured.cfg, row0, 2 * row0), row0)
        else:
            parity.replay_frame(captured.cap, small.scene, captured.params, captured.cfg)
