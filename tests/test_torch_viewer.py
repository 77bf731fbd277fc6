"""The viewer of niagara_tpu_torch (render_scene.py) and its support
modules against the JAX reference's (tools/render_scene.py,
render/hud.py, render/camera.py, utils/png.py, utils/profiling.py,
ops/shade.py:482-516): the HUD bit for bit, the PNG bytes, camera files
read and written across the two packages, the profiler's EWMA and
report, the debug views on the same frame, and the viewer itself on the
CPU (`--device cpu`) at 256x128: its PNGs, the HUD, the camera file, the
configs, the debug view, `--shadows` with `--watch` (renders once) and
the error without a GPU."""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import shade as jshade
from niagara_tpu.ops.raster import Framebuffer as JFramebuffer
from niagara_tpu.render import camera as jcamera
from niagara_tpu.render import frame as jframe
from niagara_tpu.render import hud as jhud
from niagara_tpu.utils import png as jpng
from niagara_tpu.utils import profiling as jprofiling
from niagara_tpu_torch import cooker, render_scene, scene
from niagara_tpu_torch.ops import shade
from niagara_tpu_torch.ops import raster_tile
from niagara_tpu_torch.render import camera, frame, hud, presets
from niagara_tpu_torch.utils import png, profiling
from test_torch_scene import CAPS, H, W, parity_scene

INVALID = 0x7FFFFFFF


@pytest.mark.parametrize("lines,scale,color", [
    (["frame   12.34 ms", "draws visible 1234", "clusters e/l 56/7"], 2, (1.0, 1.0, 1.0)),
    (["abcdefghijklmnopqrstuvwxyz 0123456789 .:/%-", "?!#"], 1, (0.2, 0.9, 0.4)),
    (["a line far too long for the image " * 3] * 12, 3, (1.0, 0.5, 0.0)),
])
def test_draw_hud_matches_reference(lines, scale, color):
    img = np.random.default_rng(len(lines)).random((64, 200, 3), dtype=np.float32)
    ref = np.asarray(jhud.draw_hud(jnp.asarray(img), lines, color=color, scale=scale))
    got = hud.draw_hud(torch.from_numpy(img), lines, color=color, scale=scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, img)
    np.testing.assert_array_equal(hud.draw_text(torch.from_numpy(img), "x", 300, 4).numpy(), img)


@pytest.mark.parametrize("kind", ["float", "uint8", "grey"])
def test_write_png_matches_reference(kind, tmp_path):
    rng = np.random.default_rng(7)
    img = {"float": rng.uniform(-0.2, 1.2, (33, 47, 3)).astype(np.float32),
           "uint8": rng.integers(0, 256, (16, 9, 3), dtype=np.uint8),
           "grey": rng.integers(0, 256, (5, 6), dtype=np.uint8)}[kind]
    png.write_png(str(tmp_path / "ours.png"), img)
    jpng.write_png(str(tmp_path / "ref.png"), img)
    data = (tmp_path / "ours.png").read_bytes()
    assert data == (tmp_path / "ref.png").read_bytes()
    # a valid PNG: the IDAT inflates to the filtered rows
    w, h = struct.unpack(">II", data[16:24])
    assert (h, w) == img.shape[:2]
    n = struct.unpack(">I", data[33:37])[0]
    assert len(zlib.decompress(data[41:41 + n])) == h * (1 + 3 * w)


def test_camera_files_interchangeable(tmp_path):
    cam = camera.Camera(position=np.float32([1.5, -2.0, 3.25]), orientation=np.float32([0.1, 0.2, 0.3, 0.927]),
                        fov_y=0.9, znear=0.05)
    camera.save_camera(str(tmp_path / "ours.json"), cam)
    ref = jcamera.load_camera(str(tmp_path / "ours.json"))
    jcamera.save_camera(str(tmp_path / "ref.json"), ref)
    back = camera.load_camera(str(tmp_path / "ref.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    for c in (ref, back):
        np.testing.assert_array_equal(c.position, cam.position)
        np.testing.assert_array_equal(c.orientation, cam.orientation)
        assert (c.fov_y, c.znear) == (cam.fov_y, cam.znear)
    assert back.position.dtype == back.orientation.dtype == np.float32
    (tmp_path / "v2.json").write_text('{"version": 2}')
    with pytest.raises(ValueError):
        camera.load_camera(str(tmp_path / "v2.json"))


def test_profiler_matches_reference():
    samples = [16.5, 12.0, 30.25, 8.0, 14.0]
    ours, ref = profiling.Ewma(), jprofiling.Ewma()
    assert [ours.update(s) for s in samples] == [ref.update(s) for s in samples]
    p, jp = profiling.FrameProfiler(device="cpu"), jprofiling.FrameProfiler()
    p.frame, jp.frame = ours, ref
    p.spans["cull"] = jp.spans["cull"] = profiling.Ewma(2.5, True)

    class Stats:
        early_commands, late_commands, early_clusters, late_clusters, visible_draws = 10, 2, 300, 4, 12
        cmd_dropped, cluster_dropped, tri_dropped, pair_dropped = 0, 1, 0, 3

    assert p.report(Stats(), triangles=123456) == jp.report(Stats(), triangles=123456)
    before = p.frame.value
    p.begin_frame()
    with p.span("work"):
        sum(range(10000))
    assert p.end_frame() == before * 0.95 + p.last_ms * 0.05 and p.last_ms > 0 and p.spans["work"].value > 0


@pytest.fixture(scope="module")
def debug_frame(tmp_path_factory):
    """The parity scene's second frame in both packages with the debug
    inputs: the reference's frame_core (tc, setup) and the port's capture
    (frame.debug_inputs)."""
    _, ds = parity_scene(tmp_path_factory.mktemp("mesh"))
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=1, bloom=False, raster_interpret=True, **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, bloom=False, **CAPS)
    jp, _ = jframe.make_frame_inputs(jcamera.Camera(), jcamera.RenderSettings(), jcfg)
    tp, _ = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    core = jax.jit(lambda s, st, p: jframe.frame_core(s, st, p, jcfg)[:5])
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    jfb, _, _, jstate, _ = core(ds, jstate, jp)
    jfb, jtc, jsetup, _, _ = core(ds, jstate, jp)
    tds = scene.from_numpy(ds, "cpu")
    tstate = frame.state_from_numpy(np.asarray(jstate.draw_vis), np.asarray(jstate.vis_words), "cpu")
    capture = {}
    tfb = frame.frame_core(tds, tstate, tp, tcfg, capture=capture)[0]
    return jfb, jtc, jsetup, tfb, capture


@pytest.mark.parametrize("mode", ["meshlet", "draw", "depth"])
def test_debug_visualize_matches_reference(debug_frame, mode):
    """On the same inputs (the port's frame) bit for bit; the hash modes
    also against the reference's own frame (its frame_core's tc and setup)
    wherever the two visibility buffers agree.  The reference's u32 hash
    raises OverflowError under JAX's default 32-bit mode (a Python constant
    above 2^31 meets a uint32 array, shade.py:485), so its function runs
    here with x64 enabled; the port reduces each step mod 2^32 in int64."""
    jfb, jtc, jsetup, tfb, capture = debug_frame
    tc, setup_all = frame.debug_inputs(capture)
    got = shade.debug_visualize(tfb, tc, setup_all, mode).numpy()
    with jax.enable_x64(True):
        same_in = jshade.debug_visualize(
            JFramebuffer(depth=jnp.asarray(tfb.depth.numpy()), vis=jnp.asarray(tfb.vis.numpy())),
            {k: jnp.asarray(v.numpy()) for k, v in tc.items()}, {"tri_k": jnp.asarray(setup_all["tri_k"].numpy())},
            mode)
        np.testing.assert_array_equal(got, np.asarray(same_in))
        ref = np.asarray(jshade.debug_visualize(jfb, jtc, jsetup, mode))
    assert (tfb.vis.numpy() != INVALID).sum() > 2000
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > (10 if mode != "depth" else 100)
    if mode == "depth":
        assert got.max() == 1.0
    else:
        agree = tfb.vis.numpy() == np.asarray(jfb.vis)
        assert agree.mean() > 0.999
        np.testing.assert_array_equal(got[agree], ref[agree])


@pytest.fixture
def small_viewer(monkeypatch):
    """The viewer at the small budgets (presets.small_capacities): its own
    are sized for 1080p on the card, too big for a 256x128 CPU frame."""
    monkeypatch.setattr(render_scene, "VIEWER_CAPACITIES", presets.small_capacities())


def test_viewer_renders_pngs_on_the_cpu(tmp_path, small_viewer):
    """Two 256x128 frames of 300 torus draws on the CPU: one PNG each, the
    HUD in the top-left corner, the camera file written and read back,
    each frame's own time beside the EWMA, and the debug and config
    paths."""
    out, cam_file = tmp_path / "frames", tmp_path / "view.json"
    # 6 units in front of the first draw, looking at it down -z
    at = cooker.synthesize_draws(1, draw_count=1).position[0] + np.float32([0.0, 0.0, 6.0])
    camera.save_camera(str(cam_file), camera.Camera(position=at))
    base = ["--device", "cpu", "--size", f"{W}x{H}", "--draws", "300", "--out", str(out),
            "--camera", str(cam_file)]
    res = render_scene.run(base + ["--frames", "2"])
    assert [os.path.basename(p) for p in res["paths"]] == ["frame_000.png", "frame_001.png"]
    data = (out / "frame_001.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and struct.unpack(">II", data[16:24]) == (W, H)
    assert int(res["stats"].visible_draws) > 0 and int((res["fb"].vis != INVALID).sum()) > 200
    assert all(int(getattr(res["stats"], k)) == 0 for k in ("cmd_dropped", "cluster_dropped", "tri_dropped"))
    img = res["image"]
    plain = out / "plain.png"
    png.write_png(str(plain), img.numpy())
    assert (out / "frame_001.png").read_bytes() != plain.read_bytes()
    np.testing.assert_array_equal(camera.load_camera(str(cam_file)).position, at)
    ms = res["frame_ms"]
    assert len(ms) == 2 and min(ms) > 0 and res["frame_ewma_ms"] == ms[0] * 0.95 + ms[1] * 0.05
    # config 0 expands every draw's 1,089 LOD-0 meshlets: 3 draws fit the small budgets
    for extra in (["--config", "0", "--debug", "draw", "--draws", "3"], ["--config", "1", "--downsample", "2"]):
        r = render_scene.run(base + ["--frames", "1"] + extra)
        assert r["cfg"].occlusion_two_pass is False and os.path.exists(r["paths"][0])
    assert r["image"].shape == (H // 2, W // 2, 3)


def test_viewer_debug_capture_holds_the_last_frame(tmp_path, small_viewer):
    """With --debug over two frames, `capture` receives the last rendered
    frame's kernel inputs (not the debug pass's): its raster replays to
    that frame's visibility buffer."""
    cam_file = tmp_path / "view.json"
    at = cooker.synthesize_draws(1, draw_count=1).position[0] + np.float32([0.0, 0.0, 6.0])
    camera.save_camera(str(cam_file), camera.Camera(position=at))
    capture = {}
    r = render_scene.run(["--device", "cpu", "--size", f"{W}x{H}", "--draws", "3", "--config", "0", "--debug",
                          "meshlet", "--frames", "2", "--out", str(tmp_path), "--camera", str(cam_file)],
                         capture=capture)
    assert capture["passes"] == ["early"] and "layer" in capture and "valid" in capture
    assert int((r["fb"].vis != INVALID).sum()) > 200
    depth, vis = raster_tile.raster_plain(*capture["raster"][0], W // 128)
    assert torch.equal(vis, r["fb"].vis) and torch.equal(depth, r["fb"].depth)


def test_viewer_shadows_raise_and_name_a16(tmp_path, small_viewer):
    """`--shadows` raised until ray-traced shadows were ported (ROADMAP
    A16, the name's); now it renders, and with --watch main renders once
    and returns instead of entering the watch loop."""
    out = tmp_path / "frames"
    # the plain trace's small ops on one thread: under the parallel test
    # run, torch's intra-op threads mostly wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert render_scene.main(["--watch", "--shadows", "--device", "cpu", "--size", f"{W}x{H}", "--draws", "48",
                                  "--frames", "1", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    assert os.listdir(out) == ["frame_000.png"]


def test_viewer_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        render_scene.run(["--frames", "1", "--out", str(tmp_path)])
    assert render_scene.parse_args([]).device == "cuda"
