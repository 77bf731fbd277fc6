"""The CUDA kernels of niagara_tpu_torch against their plain torch versions
on the card, on the small scene at 256x128 (cooker.small_scene_draws): setup,
tile raster and shade must agree exactly, since both sides round every op
as IEEE f32 (the kernels are built with --fmad=false).  The same for the
alpha variants of setup and raster on the textured, alpha-classed small
scene (cooker.small_alpha_scene, post_passes=2).

Marked `cuda`: skipped where there is no GPU.  On a GPU machine run
`python -m pytest tests/test_torch_kernels.py -m cuda -q`.  These do not
replace chip_smoke.py, which checks the same at headline size."""

import pytest
import torch

from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import raster_tile, setup
from niagara_tpu_torch.render import camera, frame, presets, textures

W, H = 256, 128

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
