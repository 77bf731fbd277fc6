"""The cull layer's CUDA kernels (csrc/cull.cu) against their plain twins.

On the card (marked `cuda`, skipped where there is no GPU; there, without
tests/conftest.py: `python -m pytest tests/test_torch_cull_kernels.py -m
cuda --noconftest -q`): every cull pass of a captured frame through
ops/cull.py cull_pass_cuda (draw_cull_kernel, cluster_cull_kernel, the
x-order sort and cluster_order_kernel) against cull_pass_plain on the same
inputs -- emit, lod, new_vis, each class group's x-ordered cluster list,
metadata and count, the visibility words, n_draws, the drops and the
candidates, bit for bit -- on the small scenes with post_passes 1, 2 and 3,
on the single-pass configs, on the 1M-draw torus field of the benchmark at
1920x1080 with its budgets and with budgets cut so that draws and clusters
drop, on a scene whose neighbouring draws share a visibility word pair,
and on seeded random visibility states; the pyramid kernels against
build_pyramid_plain on seeded depths at 1920x1080, 256x128 and odd sizes.

On the CPU (tier-1): the wrappers raise on a bad shape, dtype or capacity
before they look at the device; CPU tensors take the plain twins; the
launch counters exist; and the pyramid plan's levels rebuild the plain
atlas when run in numpy as the kernels run them."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import cull, pyramid, raster
from niagara_tpu_torch.render import camera, frame, parity, presets, textures

W, H = 256, 128
DEV = "cuda"
CULL_KERNELS = ("draw_cull", "cluster_cull", "cluster_order", "pyramid_base", "pyramid_filter")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")


def _frames(sc, cfg, device, n=2, tex=None, settings=None, state=None):
    """n frames of `sc` from a cold state (or `state`), the last captured."""
    params, sp = frame.make_frame_inputs(camera.Camera(), settings or camera.RenderSettings(), cfg)
    state = state or frame.init_state(sc.num_draws, sc.meshlet_visibility_count, device)
    cap = {}
    for _ in range(n):
        _, _, state, _ = frame.render_frame(sc, state, params, sp, cfg, textures=tex, capture=cap)
    return params, cap, state


def _small(tmp_path, kind, device):
    """The small scene with post_passes 1 (opaque), 2 (alpha) or 3 (glass)
    on `device`: (scene, cfg, textures)."""
    g = cooker.cook_procedural(str(tmp_path))
    post = dict(opaque=1, alpha=2, glass=3)[kind]
    if kind == "opaque":
        sc, tex = scene.from_numpy(scene.upload(g, cooker.small_scene_draws(g.meshes.count)), device), None
    else:
        make = cooker.small_alpha_scene if kind == "alpha" else cooker.small_glass_scene
        g, draws, mats, masks, mips = make(g)
        table = textures.build_texture_table(mips)
        sc = scene.from_numpy(scene.upload(g, draws, mats, masks, texture_table=table), device)
        tex = textures.to_device(table, device)
    return sc, frame.FrameConfig(width=W, height=H, post_passes=post, **presets.small_capacities()), tex


def _replay(sc, params, cap, **override):
    """Each captured cull pass (and the pyramid) through the kernels
    against the plain twin; `override` replaces pass keywords.  Returns the
    kernel outputs by pass."""
    if override:
        cap = dict(cap, cull=[(name, dict(kw, **override)) for name, kw in cap["cull"]])
    before = {k: _build.LAUNCHES[k] for k in CULL_KERNELS}
    calls = parity.replay_cull(cap, sc, params)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in CULL_KERNELS}
    groups = sum(len(c["out"]["groups"]) for c in calls if c["name"] == "cull")
    passes = sum(c["name"] == "cull" for c in calls)
    pyr = sum(c["name"] == "pyramid" for c in calls)
    assert launched == dict(draw_cull=passes, cluster_cull=passes, cluster_order=groups, pyramid_base=pyr,
                            pyramid_filter=pyr)
    return {c["pass_"] if c["name"] == "cull" else "pyramid": c["out"] for c in calls}


# --------------------------------------------------------------- CPU (tier-1)


def test_cull_launch_counters_exist():
    assert set(CULL_KERNELS) <= set(_build.LAUNCHES)
    assert "cull.cu" in _build.SOURCES and "lookback.cuh" in _build.HEADERS


@pytest.fixture(scope="module")
def cpu_small(tmp_path_factory):
    sc, cfg, tex = _small(tmp_path_factory.mktemp("mesh"), "alpha", "cpu")
    params, cap, state = _frames(sc, cfg, "cpu", tex=tex)
    return sc, cfg, params, cap, state


def test_cpu_tensors_take_the_plain_twins(cpu_small):
    """On CPU tensors cull_draws/cull_clusters are draw_cull,
    cluster_cull_direct_multi, order_clusters_by_x and
    transform_meta_direct, and build_pyramid is build_pyramid_plain: no
    kernel launches, and the frame's captured passes replay to its own
    cluster lists."""
    sc, cfg, params, cap, _ = cpu_small
    before = dict(_build.LAUNCHES)
    assert [name for name, _ in cap["cull"]] == ["early", "late"]
    for (name, kw), (tc_frame, _) in zip(cap["cull"], cap["setup"]):
        drawn = cull.cull_draws(sc, params, kw["draw_vis"], kw["vis_words"], kw["atlas"], late=kw["late"],
                                pyramid_shape=kw["pyramid_shape"], draw_capacity=kw["draw_capacity"],
                                candidate_capacity=kw["candidate_capacity"], num_classes=kw["num_classes"])
        assert drawn.kernel is None
        emit, lod, new_vis = cull.draw_cull(sc, params, kw["draw_vis"], kw["atlas"], late=kw["late"],
                                            pyramid_shape=kw["pyramid_shape"], num_classes=kw["num_classes"])
        assert torch.equal(drawn.emit, emit) and torch.equal(drawn.lod, lod) and torch.equal(drawn.new_vis, new_vis)
        groups, words, *counts = cull.cull_clusters(sc, params, drawn, cluster_capacity=kw["cluster_capacity"],
                                                    class_groups=kw["class_groups"])
        ref_groups, ref_words, *ref_counts = cull.cluster_cull_direct_multi(
            sc, params, emit, lod, kw["draw_vis"], kw["vis_words"], kw["atlas"], late=kw["late"],
            pyramid_shape=kw["pyramid_shape"], draw_capacity=kw["draw_capacity"],
            cluster_capacity=kw["cluster_capacity"], candidate_capacity=kw["candidate_capacity"],
            num_classes=kw["num_classes"] or 1, class_groups=kw["class_groups"])
        assert torch.equal(words, ref_words) and all(torch.equal(a, b) for a, b in zip(counts, ref_counts))
        for (tc, count), (cdraw, cmi, ref_count) in zip(groups, ref_groups):
            cdraw, cmi = raster.order_clusters_by_x(sc, params, cdraw, cmi, ref_count)
            ref_tc = raster.transform_meta_direct(sc, cdraw, cmi, ref_count)
            parity.same_bits(tc, ref_tc, f"cull {name}")
            assert torch.equal(count, ref_count)
        plain = cull.cull_pass_plain(sc, params, **kw)
        parity.same_bits(plain["groups"][0], tc_frame, f"cull {name} against the frame's setup input")
    depth, levels, ph, pw = cap["pyramid"]
    assert torch.equal(pyramid.build_pyramid(depth, levels, ph, pw), pyramid.build_pyramid_plain(depth, levels, ph, pw))
    assert dict(_build.LAUNCHES) == before


def test_cull_wrappers_check_before_the_device(cpu_small):
    """cull_pass_cuda and pyramid_cuda raise ValueError on a bad capacity,
    class group, dtype or shape before they look at the device; given good
    arguments on CPU tensors they have no kernel and raise RuntimeError."""
    sc, _, params, cap, _ = cpu_small
    _, kw = cap["cull"][1]
    bad = [dict(draw_capacity=0), dict(candidate_capacity=1 << 30), dict(cluster_capacity=0),
           dict(cluster_capacity=(1 << 30,)), dict(class_groups=((0,), (1,), (2,), (3,), (4,))),
           dict(class_groups=((0, 9),)), dict(class_groups=((0,), (1,)), cluster_capacity=(64, 64, 64)),
           dict(num_classes=9), dict(draw_vis=kw["draw_vis"].to(torch.int64)),
           dict(draw_vis=kw["draw_vis"][:-1]), dict(vis_words=kw["vis_words"].to(torch.int32))]
    for b in bad:
        with pytest.raises(ValueError):
            cull.cull_pass_cuda(sc, params, **dict(kw, **b))
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        cull.cull_pass_cuda(sc, params, **kw)
    depth, levels, ph, pw = cap["pyramid"]
    for args in ((depth.double(), levels, ph, pw), (depth[None], levels, ph, pw), (depth, 0, ph, pw),
                 (depth, 17, ph, pw), (depth, levels, ph, 2 * W)):
        with pytest.raises(ValueError):
            pyramid.pyramid_cuda(*args)
    with pytest.raises(ValueError, match="below the tiles"):
        pyramid.pyramid_cuda(torch.zeros((1, 20000)), 3, 1, 16384)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        pyramid.pyramid_cuda(depth, levels, ph, pw)


def _emulate_plan(depth: np.ndarray, levels: int, ph: int, pw: int) -> np.ndarray:
    """The kernels' route through pyramid._plan in numpy: level 0 in 32x32
    tiles (the nearest 3x3 min, or the 2x2 min), each tile's halvings up
    to plan.lt from its own texels only, the levels below from the last
    tile level, then every level's footprint and the zero padding."""
    plan, table, size = pyramid._plan(*depth.shape, levels, ph, pw)
    tile = 1 << _build.PYRAMID_TILE_LEVELS

    def reduce(lvl, src, i, j):
        if plan.two_x[lvl]:
            return min(src[2 * i, 2 * j], src[2 * i, 2 * j + 1], src[2 * i + 1, 2 * j], src[2 * i + 1, 2 * j + 1])
        y, x = table[plan.ny[lvl] + i], table[plan.nx[lvl] + j]
        h, w = src.shape
        return src[y:min(y + 3, h), x:min(x + 3, w)].min()

    mips = [np.full((plan.h[lvl], plan.w[lvl]), np.nan, np.float32) for lvl in range(levels)]
    for ty in range(0, plan.h[0], tile):
        for tx in range(0, plan.w[0], tile):
            for lvl in range(plan.lt + 1):
                for i in range(ty >> lvl, min((ty + tile) >> lvl, plan.h[lvl])):
                    for j in range(tx >> lvl, min((tx + tile) >> lvl, plan.w[lvl])):
                        if lvl:  # the 2x2 source lies in this tile
                            assert ty <= (2 * i) << (lvl - 1) < ty + tile and tx <= (2 * j) << (lvl - 1) < tx + tile
                        mips[lvl][i, j] = reduce(lvl, depth if lvl == 0 else mips[lvl - 1], i, j)
    for lvl in range(plan.lt + 1, levels):
        for i in range(plan.h[lvl]):
            for j in range(plan.w[lvl]):
                mips[lvl][i, j] = reduce(lvl, mips[lvl - 1], i, j)
    assert size == sum(m.size for m in mips[:plan.lt + 1])
    atlas = np.zeros((levels, ph, pw), np.float32)
    for lvl, m in enumerate(mips):
        h, w = m.shape
        pad = np.pad(m, ((0, 1), (0, 1)), mode="edge")
        atlas[lvl, :h, :w] = np.minimum(np.minimum(pad[:-1, :-1], pad[:-1, 1:]), np.minimum(pad[1:, :-1], pad[1:, 1:]))
    return atlas


@pytest.mark.parametrize("h, w", [(128, 256), (37, 23), (8, 128), (1, 2), (40, 1920)])
def test_pyramid_plan_rebuilds_the_plain_atlas(h, w):
    """pyramid._plan's levels (which halve exactly, the tiles' last level,
    the nearest-texel tables) give build_pyramid_plain's atlas when run in
    numpy as the kernels run them; at 1920x1080 the tiles build levels 0-5
    and block 0 levels 6-10."""
    rng = np.random.default_rng(h * 1000 + w)
    depth = rng.random((h, w), dtype=np.float32)
    levels, ph, pw = pyramid.pyramid_shape(w, h)
    want = pyramid.build_pyramid_plain(torch.from_numpy(depth), levels, ph, pw).numpy()
    assert np.array_equal(_emulate_plan(depth, levels, ph, pw), want)
    plan = pyramid._plan(1080, 1920, *pyramid.pyramid_shape(1920, 1080))[0]
    assert (plan.levels, plan.lt, plan.two_x[0], plan.h[6], plan.w[6]) == (11, 5, 0, 16, 16)


# ----------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["opaque", "alpha", "glass"])
def test_cull_kernels_match_plain_small(tmp_path, kind):
    """post_passes 1, 2 and 3: the early pass and the late pass (its
    classes merged, the write-back, one or two class groups) and the
    pyramid of a transitional and a steady frame, bit for bit."""
    _need_cuda()
    sc, cfg, tex = _small(tmp_path, kind, DEV)
    for n in (1, 3):
        params, cap, _ = _frames(sc, cfg, DEV, n=n, tex=tex)
        out = _replay(sc, params, cap)
        assert len(out["late"]["groups"]) == len(cfg.late_class_groups)
        # from a cold state the late pass takes everything; later the early
        assert int(out["late" if n == 1 else "early"]["counts"][0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", [0, 1])
def test_cull_kernels_single_pass(tmp_path, config):
    """Configs 0 and 1 (occlusion_two_pass=False): the early pass over
    all-ones visibility, no pyramid."""
    _need_cuda()
    sc, _, _ = _small(tmp_path, "opaque", DEV)
    cfg = frame.FrameConfig(width=W, height=H, **presets.small_capacities(), **presets.frame_overrides(config))
    params, cap, _ = _frames(sc, cfg, DEV, settings=presets.settings_for(config))
    assert cap["pyramid"] is None and [name for name, _ in cap["cull"]] == ["early"]
    assert int(_replay(sc, params, cap)["early"]["counts"][0]) > 0


@pytest.mark.cuda
def test_cull_kernels_shared_word_pair(tmp_path):
    """Visibility offsets packed tight (each draw's slots right after the
    previous draw's, not rounded to 64), so neighbouring draws share a
    word pair: the late write-back's clears all land before its bits, as
    the plain version's scatter does."""
    _need_cuda()
    g = cooker.cook_procedural(str(tmp_path))
    np_scene = scene.upload(g, cooker.small_scene_draws(g.meshes.count))
    per_draw = np_scene.draw_lod_meshlet_count.max(axis=1).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(per_draw)[:-1]]).astype(np.int32)
    assert (offsets % 64 != 0).any()
    np_scene = dataclasses.replace(np_scene, draw_vis_offset=offsets)
    sc = scene.from_numpy(np_scene, DEV)
    cfg = frame.FrameConfig(width=W, height=H, **presets.small_capacities())
    for n in (2, 4):
        params, cap, _ = _frames(sc, cfg, DEV, n=n)
        _replay(sc, params, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_cull_kernels_random_state(tmp_path, seed):
    """Seeded random draw visibility and visibility words (the skip, the
    early pass's bit test and the write-back over every state), with
    cluster occlusion and the cone cull on and off."""
    _need_cuda()
    sc, cfg, tex = _small(tmp_path, "alpha", DEV)
    params, cap, _ = _frames(sc, cfg, DEV, tex=tex)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dv = torch.randint(0, 2, (sc.num_draws,), generator=gen, device=DEV, dtype=torch.int32)
    words = torch.randint(0, 1 << 32, cap["cull"][0][1]["vis_words"].shape, generator=gen, device=DEV)
    _replay(sc, params, cap, draw_vis=dv, vis_words=words)
    for flags in (dict(cluster_occlusion_enabled=0), dict(cluster_backface_enabled=0), dict(lod_enabled=0),
                  dict(occlusion_enabled=0), dict(culling_enabled=0)):
        _replay(sc, dataclasses.replace(params, **flags), cap, draw_vis=dv, vis_words=words)


@pytest.fixture(scope="module")
def torus_field(tmp_path_factory):
    """The benchmark's torus_1m field (framebench/configs/torus_1m.json,
    seed 66) on the card at 1920x1080 with its budgets, three frames from
    a cold state, the last captured."""
    _need_cuda()
    sys.path.insert(0, os.path.join(ROOT, "framebench"))
    from kinds import torus_field as kind

    with open(os.path.join(ROOT, "framebench", "configs", "torus_1m.json")) as f:
        config = json.load(f)
    x = kind.make_inputs(config, 66)
    g = kind.program_geometry(config, str(tmp_path_factory.mktemp("torus")))
    sc = scene.from_numpy(scene.upload(g, scene.Draws(**x.draw_arrays()), x.materials), DEV)
    caps = dict(config["capacities"], pair_class_caps=tuple(config["capacities"]["pair_class_caps"]))
    cfg = frame.FrameConfig(width=config["width"], height=config["height"], post_passes=config["post_passes"], **caps)
    settings = camera.RenderSettings(draw_distance=config["draw_distance"])
    params, cap, _ = _frames(sc, cfg, DEV, n=3, settings=settings)
    return sc, cfg, params, cap


@pytest.mark.cuda
def test_cull_kernels_torus_field(torus_field):
    """1M draws at 1080p with the benchmark's budgets: both passes and the
    pyramid bit for bit."""
    sc, cfg, params, cap = torus_field
    out = _replay(sc, params, cap)
    assert all(int(out[name]["n_candidates"]) > 1000 for name in ("early", "late"))
    assert cap["pyramid"][0].shape == (1080, 1920)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", ["draws", "candidates", "clusters"])
def test_cull_kernels_torus_field_cut(torus_field, cut):
    """The field's passes with a budget cut so that whole draws (the draw
    list or the candidate list overflows) or clusters drop."""
    sc, cfg, params, cap = torus_field
    override = dict(draws=dict(draw_capacity=4096), candidates=dict(candidate_capacity=20000),
                     clusters=dict(cluster_capacity=1000))[cut]
    out = _replay(sc, params, cap, **override)
    key = "cluster_dropped" if cut == "clusters" else "draw_dropped"
    assert any(int(out[name][key]) > 0 for name in ("early", "late"))


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", [(1080, 1920), (128, 256), (37, 23), (8, 128), (1, 2), (40, 1920)])
def test_pyramid_kernels_match_plain(h, w):
    """Seeded depths (with zeros, as cleared pixels read) through both
    pyramid kernels against build_pyramid_plain."""
    _need_cuda()
    gen = torch.Generator(device=DEV).manual_seed(h + w)
    depth = torch.rand((h, w), generator=gen, device=DEV)
    depth[torch.rand((h, w), generator=gen, device=DEV) < 0.2] = 0.0
    levels, ph, pw = pyramid.pyramid_shape(w, h)
    before = (_build.LAUNCHES["pyramid_base"], _build.LAUNCHES["pyramid_filter"])
    got = pyramid.build_pyramid(depth, levels, ph, pw)
    assert (_build.LAUNCHES["pyramid_base"], _build.LAUNCHES["pyramid_filter"]) == (before[0] + 1, before[1] + 1)
    parity.same_bits(got, pyramid.build_pyramid_plain(depth, levels, ph, pw), f"pyramid {h}x{w}")
