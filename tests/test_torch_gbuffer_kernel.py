"""The G-buffer kernel (csrc/gbuffer.cu) against its plain twin.

On the card (marked `cuda`, skipped where there is no GPU; there, without
tests/conftest.py: `python -m pytest tests/test_torch_gbuffer_kernel.py -m
cuda --noconftest -q`): ops/shade.py gbuffer_cuda against gbuffer_plain on
the same inputs -- g0, g1 and valid bit for bit, the kernel's count of
shaded pixels equal to the twin's valid pixels -- on the small scenes'
captured frames: the checker materials with the alpha discard, the glass
scene's main and layer G-buffers with normal maps, untextured, one
material, slot 0 through mip_rows instead of the rows' mip metadata, a
table without quads, odd sizes (the tangent frame's last row and column),
no valid pixel, the maps ignored (no depth) and seeded uv and duv noise
over every mip; and on the benchmark's torus_1m and glass_1m frames at
1920x1080 (render/parity.py replay_gbuffer, main and layer).

On the CPU (tier-1): gbuffer_from_attrs takes the plain twin for CPU
tensors (no launch; the frame's own G-buffer; invalid pixels zero, the
alpha discard and the normal map doing their work) and the kernel wrapper
refuses them; the counters "G-buffer pixels" and "layer G-buffer pixels"
equal the valid masks' counts against the frame's pixels, the layer's only
with post_passes=3."""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import shade
from niagara_tpu_torch.ops.raster import INVALID_FRAG
from niagara_tpu_torch.render import camera, frame, parity, presets, textures
from niagara_tpu_torch.utils.profiling import StageTimer

W, H = 256, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POST = dict(opaque=1, alpha=2, glass=3)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")


def _small(geometry, kind, device, stages=None):
    """The small scene of `kind` on `device`, two frames from a cold state
    (the second with `stages` and captured): (scene, textures, cfg, shade
    params, capture)."""
    if kind == "opaque":
        draws = cooker.small_scene_draws(geometry.meshes.count)
        sc, tex = scene.from_numpy(scene.upload(geometry, draws), device), None
    else:
        make = cooker.small_alpha_scene if kind == "alpha" else cooker.small_glass_scene
        g, draws, mats, masks, mips = make(geometry)
        table = textures.build_texture_table(mips)
        sc = scene.from_numpy(scene.upload(g, draws, mats, masks, texture_table=table), device)
        tex = textures.to_device(table, device)
    cfg = frame.FrameConfig(width=W, height=H, post_passes=POST[kind], **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, device)
    state = frame.render_frame(sc, state, params, sp, cfg, textures=tex)[2]
    if stages is not None:
        stages.begin()
    cap = {}
    frame.render_frame(sc, state, params, sp, cfg, textures=tex, capture=cap, stages=stages)
    return sc, tex, cfg, sp, cap


def _inputs(small, layer=False):
    """gbuffer_from_attrs' inputs of a captured frame's main (or layer)
    G-buffer: (attrs, valid, scene, textures, keywords)."""
    sc, tex, _, sp, cap = small
    src = cap["layer"] if layer else dict(cap, vis=cap["shade"][1])
    return (src["attrs"], src["vis"] != INVALID_FRAG, sc, tex,
            dict(depth=src["depth"], inverse_view_projection=sp.inverse_view_projection))


# --------------------------------------------------------------- CPU (tier-1)


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    return cooker.cook_procedural(str(tmp_path_factory.mktemp("gbuffer")))


@pytest.fixture(scope="module")
def cpu_glass(geometry):
    timer = StageTimer("cpu")
    return _small(geometry, "glass", "cpu", stages=timer), timer.resolve()[0]


def test_gbuffer_launch_counter_and_source_exist():
    assert "gbuffer" in _build.LAUNCHES and "gbuffer.cu" in _build.SOURCES
    assert "gbuffer_launch" in _build._SIGNATURES


@pytest.mark.parametrize("layer", [False, True], ids=["main", "layer"])
def test_cpu_tensors_take_the_plain_twin(cpu_glass, layer):
    """On CPU tensors gbuffer_from_attrs is gbuffer_plain, launches nothing,
    and gives the frame's own G-buffer; the kernel wrapper refuses them."""
    small, _ = cpu_glass
    cap = small[4]
    attrs, valid, sc, tex, kw = _inputs(small, layer)
    before = dict(_build.LAUNCHES)
    got = shade.gbuffer_from_attrs(attrs, valid, sc, tex, **kw)
    assert dict(_build.LAUNCHES) == before
    parity.same_bits(got, shade.gbuffer_plain(attrs, valid, sc, tex, **kw), "dispatch against the twin")
    own = cap["layer"] if layer else cap
    parity.same_bits(got, (own["g0"], own["g1"], own["valid"]), "dispatch against the frame's")
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        shade.gbuffer_cuda(attrs, valid, sc, tex, **kw)


def test_plain_twin_zeroes_discards_and_bends(cpu_glass):
    """The twin's output on the glass frame: invalid pixels zero, only
    covered pixels valid, the layer's G-buffer too; the normal map bends
    normals (ignored without depth, where the other channels hold)."""
    small, _ = cpu_glass
    for layer in (False, True):
        attrs, valid, sc, tex, kw = _inputs(small, layer)
        g0, g1, v = shade.gbuffer_plain(attrs, valid, sc, tex, **kw)
        assert int(v.sum()) > 100 and bool((v <= valid).all())
        assert not g0[~v].any() and not g1[~v].any()
        u0, u1, uv = shade.gbuffer_plain(attrs, valid, sc, tex, depth=None, inverse_view_projection=None)
        assert torch.equal(u0, g0) and torch.equal(uv, v) and torch.equal(u1[..., 2:], g1[..., 2:])
        if not layer:
            assert int((u1[..., :2] != g1[..., :2]).any(dim=-1).sum()) > 100, "the normal map bends nothing"


@pytest.mark.parametrize("kind", ["glass", "opaque"])
def test_gbuffer_counters(geometry, cpu_glass, kind):
    """"G-buffer pixels" and, with the layer (post_passes=3), "layer
    G-buffer pixels": the valid masks' counts against the frame's pixels;
    with post_passes=1 the main counter alone."""
    if kind == "glass":
        (_, _, _, _, cap), f = cpu_glass
    else:
        timer = StageTimer("cpu")
        cap = _small(geometry, "opaque", "cpu", stages=timer)[4]
        f = timer.resolve()[0]
    c = f["counters"]
    assert c["G-buffer pixels"] == ((int(cap["valid"].sum()),), (W * H,))
    assert ("layer G-buffer pixels" in c) == (kind == "glass")
    if kind == "glass":
        assert c["layer G-buffer pixels"] == ((int(cap["layer"]["valid"].sum()),), (W * H,))
        assert c["layer G-buffer pixels"][0][0] > 0
    assert c["G-buffer pixels"][0][0] > 0


# --------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def card(geometry):
    """The small opaque, alpha and glass scenes' captured frames on the card."""
    _need_cuda()
    return {kind: _small(geometry, kind, "cuda") for kind in POST}


def _hold(attrs, valid, sc, tex, **kw):
    """gbuffer_cuda against gbuffer_plain: one launch, outputs bit for bit,
    the count equal to the valid pixels.  Returns the twin's outputs."""
    before = _build.LAUNCHES["gbuffer"]
    *k_out, shaded = shade.gbuffer_cuda(attrs, valid, sc, tex, **kw)
    assert _build.LAUNCHES["gbuffer"] == before + 1
    p_out = shade.gbuffer_plain(attrs, valid, sc, tex, **kw)
    parity.same_bits(tuple(k_out), p_out, "gbuffer_cuda against gbuffer_plain")
    assert int(shaded[0]) == int(p_out[2].sum())
    return p_out


def _noisy(attrs, seed):
    """attrs with seeded uvs over [-4, 4) and duv over 1e-7..1e3: every
    wrap and every mip."""
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    a = attrs.clone()
    a[..., 3:5] = torch.rand(a[..., 3:5].shape, generator=gen, device=a.device) * 8.0 - 4.0
    a[..., 12] = torch.pow(10.0, torch.rand(a[..., 12].shape, generator=gen, device=a.device) * 10.0 - 7.0)
    return a


def _crop(attrs, valid, sc, tex, kw, h, w):
    kw = dict(kw, depth=None if kw["depth"] is None else kw["depth"][:h, :w].contiguous())
    return attrs[:h, :w].contiguous(), valid[:h, :w].contiguous(), sc, tex, kw


CASES = {
    "checker alpha discard": lambda c: _inputs(c["alpha"]),
    "glass main normal maps": lambda c: _inputs(c["glass"]),
    "glass layer normal maps": lambda c: _inputs(c["glass"], layer=True),
    "untextured": lambda c: (*_inputs(c["alpha"])[:3], None, _inputs(c["alpha"])[4]),
    "one material untextured": lambda c: _inputs(c["opaque"]),
    "one material textured": lambda c: (lambda a, v, sc, t, kw: (a, v, dataclasses.replace(
        sc, mat_row=sc.mat_row[:1].contiguous()), t, kw))(*_inputs(c["alpha"])),
    "mip_rows path": lambda c: (lambda a, v, sc, t, kw: (a, v, dataclasses.replace(
        sc, has_texture_meta=False), t, kw))(*_inputs(c["glass"])),
    "no quads": lambda c: (lambda a, v, sc, t, kw: (a, v, sc, dataclasses.replace(t, texels_quad=None), kw))(
        *_inputs(c["glass"])),
    "odd size": lambda c: _crop(*_inputs(c["glass"]), 77, 101),
    "odd size layer": lambda c: _crop(*_inputs(c["glass"], layer=True), 93, 129),
    "no valid pixel": lambda c: (lambda a, v, sc, t, kw: (a, torch.zeros_like(v), sc, t, kw))(*_inputs(c["glass"])),
    "maps ignored": lambda c: (lambda a, v, sc, t, kw: (a, v, sc, t, dict(kw, depth=None)))(*_inputs(c["glass"])),
    "uv noise": lambda c: (lambda a, v, sc, t, kw: (_noisy(a, 3), v, sc, t, kw))(*_inputs(c["glass"])),
    "uv noise no quads": lambda c: (lambda a, v, sc, t, kw: (_noisy(a, 4), v, sc, dataclasses.replace(
        t, texels_quad=None), kw))(*_inputs(c["alpha"])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_gbuffer_kernel_matches_plain(card, case):
    attrs, valid, sc, tex, kw = CASES[case](card)
    g0, g1, v = _hold(attrs, valid, sc, tex, **kw)
    if case == "no valid pixel":
        assert not v.any() and not g0.any() and not g1.any()
    else:
        assert int(v.sum()) > 100
    if case.startswith("uv noise"):
        # random uvs land on the checker's clear cells: the post-pass
        # discard has pixels to take
        assert int(v.sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(POST))
def test_frame_gbuffers_launch_the_kernel(card, kind):
    """render_frame on the card: one kernel launch a G-buffer (two with
    the layer), and the replay (render/parity.py replay_gbuffer) bit for
    bit against the twin and the frame's own output."""
    sc, tex, cfg, sp, cap = card[kind]
    params, _ = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, "cuda")
    before = _build.LAUNCHES["gbuffer"]
    frame.render_frame(sc, state, params, sp, cfg, textures=tex)
    assert _build.LAUNCHES["gbuffer"] - before == (2 if kind == "glass" else 1)
    calls = parity.replay_gbuffer(cap, sc, tex, sp.inverse_view_projection)
    assert [c["pass_"] for c in calls] == ["gbuffer"] + (["gbuffer layer"] if kind == "glass" else [])


@pytest.fixture(scope="module", params=["torus_1m.static", "glass_1m.static"])
def bench_frame(request, tmp_path_factory):
    """The benchmark cell's configuration on the card at 1920x1080 (its
    scene, textures, budgets and camera path; unshadowed: the G-buffer
    does not read the shadow), three frames from a cold state, the last
    captured."""
    _need_cuda()
    fb = os.path.join(ROOT, "framebench")
    if fb not in sys.path:
        sys.path.insert(0, fb)
    import run as fb_run
    from core import renderer

    _, _, config, mix, _ = fb_run.load_cell(request.param, ROOT)
    kind, cam, motion = fb_run.cell_hooks(config, mix, ROOT)
    x = kind.make_inputs(config, 1234567891)
    geometry = kind.program_geometry(config, str(tmp_path_factory.mktemp("fb")))
    prog = renderer.Renderer(config, dict(mix, shadows="none"), x, geometry, "cuda", 1234567891, cam, motion)
    state, cap = prog.init_state(), {}
    for i in range(3):
        state = prog.step(i, state, capture=cap if i == 2 else None)["state"]
    _, sp = prog.frame_inputs(2)
    yield request.param, prog, sp, cap
    prog.free()


@pytest.mark.cuda
def test_gbuffer_kernel_bench_frame(bench_frame):
    """The benchmark frame's G-buffers (main, and glass's layer) bit for
    bit against the twin and the frame's own output."""
    cell, prog, sp, cap = bench_frame
    calls = parity.replay_gbuffer(cap, prog.ds, prog.tex, sp.inverse_view_projection)
    assert len(calls) == (2 if cell.startswith("glass") else 1)
    assert tuple(cap["g0"].shape) == (1080, 1920, 4) and int(cap["valid"].sum()) > 100_000
