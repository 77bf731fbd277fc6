"""The port's spans and counters (utils/profiling.py `span`,
`StageTimer.count`) and the benchmark's split of the device's idle time
over them (framebench/core/spans.py), on the CPU at 256x128 with
presets.small_capacities().

* A frame of each shadow path (the sun map's band update and the
  ray-traced walk) with a StageTimer resolves to the stage names it had
  before the stages became spans, in the same order (pinned here).
* Without a StageTimer and without the profiler a frame enters
  record_function 0 times, counts nothing and dispatches the same
  operations as with a StageTimer, whose counts launch nothing inside the
  frame.
* Under the CPU profiler a frame's Chrome trace holds every
  "niagara::<stage>" span as a user annotation, in the order it ran.
* The counters equal what the frame reports elsewhere: the passes' pair
  demand adds up to FrameStats' demand and pair count, against the
  budgets emit_pairs applies; the sun band's pair demand equals its
  captured pair count; "rt steps" equals trace_plain's step sum on the
  captured rays.
* core/spans.py on a synthetic trace: the split adds up to the trace's
  idle time exactly, a gap that straddles spans is cut between them, the
  innermost span of nested ones takes its part, and a run without a trace
  or without spans reads None.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.ops import raster_tile, shadow, sunmap
from niagara_tpu_torch.render import camera, frame, presets, textures
from niagara_tpu_torch.utils.profiling import StageTimer, span, stage_marker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, MAP = 256, 128, 256
CAPS = presets.small_capacities()
SUN_CAPS = dict(cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15)
FRAME = ["early draw cull", "early cluster cull", "early setup", "early emit+sort+raster", "pyramid", "late cull",
         "late setup+raster", "shade", "G-buffer", "bloom"]
STAGES = {
    "sun": ["sun cull", "sun setup", "sun raster", "pack_band"] + FRAME + ["sun-map resolve+blur", "composite"],
    "rt": FRAME + ["rt rays+trace", "rt fill+blur", "composite"],
}
# the profiler's spans: the frame's inputs, then the program's stages
# ("pack_band" is the splice's own span; its StageTimer boundary is the
# caller's mark)
SPANS = {"sun": ["frame inputs"] + STAGES["sun"], "rt": ["frame inputs"] + STAGES["rt"]}


def _load(name):
    path = os.path.join(REPO, "framebench", "core", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"framebench_core_{name}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: under the parallel run's other workers torch's
    intra-op threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    g = cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))
    ga, da, mats, masks, mips = cooker.small_alpha_scene(g)
    table = textures.build_texture_table(mips)
    sc = scene.from_numpy(scene.upload(ga, da, mats, masks, texture_table=table), "cpu")
    return types.SimpleNamespace(ga=ga, da=da, table=textures.to_device(table, "cpu"), scene=sc)


def _path(small, kind):
    """step(state, stages, capture=None) -> (image, fb, state, stats) of
    one frame of `kind` from its inputs on, and the initial state.  The
    sun path updates the band of the last three draws and splices it as
    framebench's frame loop does (its "pack_band" boundary the caller's)."""
    sc = small.scene
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, shadows=True, **CAPS)
    kw = dict(textures=small.table)
    if kind == "rt":
        kw["bvh"] = shadow.build_scene_rt(small.ga, small.da)[0]
    else:
        _, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        n = sc.num_draws - 3
        sf = sunmap.fit_sun_to_draws(sp.sun_direction, small.da, device="cpu")
        texel = sunmap.map_texel_world(sf, MAP, MAP)
        static, sdrop = sunmap.build_static_sun_map(sc, sf, map_w=MAP, map_h=MAP, texel_world=texel, batch=16,
                                                    num_draws=n, **SUN_CAPS)
        assert int(sdrop) == 0
        tail = sc.slice_draws(n, sc.num_draws)
        window = sunmap.dirty_tile_rows(sf, tail.draw_position, tail.draw_mesh_row[:, 3] * tail.draw_scale, MAP,
                                        margin=4.0 + 2.0 * texel)
        a, b = window[0] * 8, (window[0] + window[1]) * 8
        packed_static = sunmap.pack_sun_map(static)

    def step(state, stages, capture=None, sun_capture=None):
        params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        sun = None
        if kind == "sun":
            band, _ = sunmap.update_sun_map(tail, sf, static, None, map_w=MAP, map_h=MAP, texel_world=texel,
                                            row_window=window, stages=stages, capture=sun_capture, **SUN_CAPS)
            packed = sunmap.pack_band(packed_static, band, a, MAP, row_above=static[a - 1] if a > 0 else None,
                                      row_below=static[b] if b < MAP else None)
            stage_marker(stages)("pack_band")
            sun = (sf, packed, (MAP, MAP))
        return frame.render_frame(sc, state, params, sp, cfg, sun=sun, capture=capture, stages=stages, **kw)

    return step, frame.init_state(sc.num_draws, sc.meshlet_visibility_count, "cpu")


class _CountOps(TorchDispatchMode):
    """The operations dispatched inside it that compute (views left out:
    they launch nothing)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["sun", "rt"])
def test_stage_rows_keep_their_names_and_order(small, kind):
    step, state = _path(small, kind)
    timer = StageTimer("cpu")
    for _ in range(2):
        timer.begin()
        state = step(state, timer)[2]
    frames = timer.resolve()
    assert [[r[0] for r in f["stages"]] for f in frames] == [STAGES[kind]] * 2
    assert all(r[1] > 0 for f in frames for r in f["stages"])


@pytest.mark.parametrize("kind", ["sun", "rt"])
def test_untraced_frame_enters_no_record_function(small, kind, monkeypatch):
    step, state = _path(small, kind)
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)

    def no_count(*a, **kw):
        raise AssertionError("a frame without a StageTimer counted")

    count = StageTimer.count
    monkeypatch.setattr(StageTimer, "count", no_count)
    assert span(None, "a") is span(None, "b"), "one shared no-op context"
    with _CountOps() as plain:
        image = step(state, None)[0]
    assert entered == []
    monkeypatch.setattr(StageTimer, "count", count)
    timer = StageTimer("cpu")
    timer.begin()
    with _CountOps() as timed:
        timed_image = step(state, timer)[0]
    assert entered == []
    assert torch.equal(image, timed_image)
    # the StageTimer's counts launch nothing inside the frame; the walk's
    # step sum and, on the CPU route, the sun-map resolve's tested texels
    # (the kernel counts them on the card) are the counts computed there
    extra = list(timed.ops)
    for op in plain.ops:
        extra.remove(op)
    assert sorted(extra) == (["aten.gt.Scalar", "aten.sum.default"] if kind == "sun"
                             else ["aten.remainder.Scalar", "aten.sum.default"]), extra


@pytest.mark.parametrize("kind", ["sun", "rt"])
def test_profiler_trace_holds_every_span(small, kind, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    step, state = _path(small, kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, None)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    spans = sorted((e["ts"], e["name"], e.get("cat")) for e in events
                   if e.get("ph") == "X" and e.get("name", "").startswith("niagara::"))
    assert [n[len("niagara::"):] for _, n, _ in spans] == SPANS[kind]
    assert {c for _, _, c in spans} == {"user_annotation"}


def test_counters_equal_the_frame_stats(small):
    step, state = _path(small, "rt")
    timer, cap = StageTimer("cpu"), {}
    timer.begin()
    stats = step(state, timer, capture=cap)[3]
    (f,) = timer.resolve()
    c = f["counters"]
    assert set(c) == {"early pair classes", "early pairs", "late pair classes", "late pairs", "rt steps",
                      "G-buffer pixels"}
    assert c["G-buffer pixels"] == ((int(cap["valid"].sum()),), (cap["valid"].numel(),))
    assert int(stats.pair_dropped) == 0
    demand = np.sum([c[f"{p} pair classes"][0] for p in ("early", "late")], axis=0)
    np.testing.assert_array_equal(demand, stats.pair_demand_vec.numpy()[1:])
    assert c["early pairs"][0][0] + c["late pairs"][0][0] == int(stats.pair_count)
    for p, tri_cap, pair_cap in (("early", CAPS["tri_capacity"], CAPS["pair_capacity"]),
                                 ("late", CAPS["late_tri_capacity"], CAPS["pair_capacity"])):
        assert c[f"{p} pair classes"][1] == raster_tile.class_budgets(tri_cap)
        assert c[f"{p} pairs"][1] == (pair_cap,)
    tr = cap["trace"]
    bvh = shadow.build_scene_rt(small.ga, small.da)[0]
    _, steps = shadow.trace_plain(bvh, tr["origin"], tr["direction"], max_steps=tr["max_steps"],
                                  alpha_test=tr["alpha_test"])
    walked = torch.where(steps < 0, tr["max_steps"], steps)
    assert c["rt steps"] == ((int(walked.sum()),), (steps.numel(),))
    assert c["rt steps"][0][0] > steps.numel() > 0


def test_sun_band_counters(small):
    step, state = _path(small, "sun")
    timer, sun_cap = StageTimer("cpu"), {}
    for _ in range(2):  # the first frame's counts are flushed by the second's begin
        timer.begin()
        stats = step(state, timer, sun_capture=sun_cap)[3]
    frames = timer.resolve()
    for f in frames:
        c = f["counters"]
        assert c["sun pairs"] == ((int(sun_cap["pairs"]),), (SUN_CAPS["pair_capacity"],))
        assert c["sun pair classes"][1] == raster_tile.class_budgets(SUN_CAPS["tri_capacity"])
        assert sum(c["sun pair classes"][0]) <= int(sun_cap["tris"])
        assert c["early pairs"][0][0] + c["late pairs"][0][0] == int(stats.pair_count)


def test_stage_timer_count_checks_its_bases():
    timer = StageTimer("cpu")
    timer.begin()
    with pytest.raises(ValueError):
        timer.count("x", torch.tensor([1, 2]), 3)
    timer.count("x", torch.tensor([1, 2]), (3, 4))
    timer.count("x", torch.tensor([5, 6]), [7, 8])
    timer.count("y", torch.tensor(9), 10)
    timer.begin()
    (f0, f1) = timer.resolve()
    assert f0["counters"] == {"x": ((6, 8), (10, 12)), "y": ((9,), (10,))}
    assert f1["counters"] == {}


# ---- framebench/core/spans.py ----

def _trace(events, spans, window_us, frames=2):
    mod = _load("trace")
    host = [(f"niagara::{n}", a, b - a) for n, a, b in spans] + [("aten::add", 20.0, 5.0)]
    dev = sorted((("k", "kernel", a, b - a) for a, b in events), key=lambda e: e[2])
    return mod.Trace(dev, host, frames, window_us * 1e-6)


def test_idle_split_adds_up_and_cuts_straddling_gaps():
    spans = _load("spans")
    # device busy [0,10] [30,33] [45,60] [100,110]; window 130 us ending at
    # 110: idle [-20,0] [10,30] [33,45] [60,100]
    tr = _trace([(0, 10), (30, 33), (45, 60), (100, 110)], [("a", 5, 35), ("b", 35, 90), ("c", 50, 70)], 130)
    split = spans.idle_us_by_span(tr)
    assert split == pytest.approx({None: 20 + 10, "a": 20 + 2, "b": 10 + 20, "c": 10})
    idle_us = tr.window_s * 1e6 - tr.busy_s() * 1e6
    assert sum(split.values()) == pytest.approx(idle_us, abs=1e-9)
    run = types.SimpleNamespace(trace=tr)
    assert spans.idle_ms(run, ("a", "c")) == pytest.approx(32e-3 / 2)
    assert spans.idle_ms(run, (None, "b")) == pytest.approx(60e-3 / 2)
    assert spans.idle_ms(run, ("nowhere",)) is None


def test_idle_split_reads_none_without_trace_or_spans():
    spans = _load("spans")
    assert spans.idle_us_by_span(None) is None
    assert spans.idle_ms(types.SimpleNamespace(trace=None), ("a",)) is None
    tr = _trace([(0, 10), (20, 30)], [], 40)
    assert spans.idle_us_by_span(tr) is None
    assert spans.idle_ms(types.SimpleNamespace(trace=tr), (None,)) is None
