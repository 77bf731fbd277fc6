"""The glass field (framebench/kinds/glass_field.py, ref/glass.py,
data/glass_field.py) and what the port gives it to read (render/frame.py's
"layer G-buffer" span, "glass clusters" counter and the capture's normals),
on the CPU at a tiny size: the torus field's tiny root
(framebench/tinyrun.py) with `glass_1m` cut the same way.

* The frozen normal map and class move equal the port's glass_scene byte
  for byte.
* The tiny glass cell runs `correct` through run.run, with the kind's own
  numbers and the transmission layer's metrics in its line.
* Each fault planted in a copy of one of the port's functions fails the
  kind's number that watches it: the blend dropped, the blend applied
  where the layer is behind, the transmission group culled away, normal
  maps ignored.
* The reference and the frozen data import nothing of the port, and the
  kind's reference hooks pass the harness's guard.
* "layer G-buffer" and "glass clusters" come with post_passes=3 and not
  with 2, the counter equals the transmission group's cluster count, and
  untraced the span records and launches nothing.
* The three readers on synthetic runs, None where there is nothing to read.
"""

from __future__ import annotations

import ast
import contextlib
import inspect
import json
import os
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FB = os.path.join(REPO, "framebench")
for _p in (FB, REPO):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import tinyrun  # noqa: E402

from niagara_tpu_torch import cooker, scene  # noqa: E402
from niagara_tpu_torch.ops import cull, shade, sunmap  # noqa: E402
from niagara_tpu_torch.render import camera, frame, presets, textures  # noqa: E402
from niagara_tpu_torch.utils.profiling import StageTimer  # noqa: E402

CELL = "glass_1m.static"
SEED = 5
CPU = torch.device("cpu")
# the kind's limits at the tiny size, beside tinyrun's: 256x128 pixels are
# coarse next to the tori, so the layer's edges and textures differ over
# more of its front than at 1080p
TINY_GLASS_LIMITS = dict(layer_geom=0.6, layer_visible=0.4, layer_missed=0.1, layer_image=0.35, layer_behind=0.3,
                         normal=0.5)


def glass_root(dest: str) -> str:
    """tinyrun's root with glass_1m cut as it cuts torus_1m, and the glass
    cell's limits TINY_LIMITS and TINY_GLASS_LIMITS."""
    root = tinyrun.make_root(dest)
    fb = os.path.join(root, "framebench")
    path = os.path.join(fb, "configs", "glass_1m.json")
    with open(path) as f:
        c = json.load(f)
    c.update(samples=2048, draws=400, scatter_range=12.0, width=256, height=128, capacities=tinyrun.SMALL_CAPS,
             sun_map=tinyrun.SMALL_SUN)
    with open(path, "w") as f:
        json.dump(c, f)
    with open(os.path.join(fb, "limits", f"{CELL}.json"), "w") as f:
        json.dump(dict(tinyrun.TINY_LIMITS, **TINY_GLASS_LIMITS), f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return glass_root(str(tmp_path_factory.mktemp("glass")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: under the parallel run's other workers torch's
    intra-op threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the frozen data ----

def test_frozen_normal_map_and_classes_equal_glass_scene():
    from data import glass_field, torus_field

    from niagara_tpu_torch.cooker import synth

    want = synth.synthesize_normal_map()
    got = glass_field.normal_map(256, 3)
    assert len(want) == len(got) and all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                                         for a, b in zip(want, got))
    g = cooker.cook_procedural()
    draws = synth.synthesize_draws(g.meshes.count, draw_count=64)
    _, d, mats, _, mips = synth.glass_scene(g, draws)
    fmats, fmips, mat_idx, post = torus_field.checker_materials(64)
    fmips = glass_field.glass_classes(fmats, fmips, mat_idx, post)
    assert post.tobytes() == d.post_pass.tobytes() and mat_idx.tobytes() == d.material_index.tobytes()
    assert (post == 2).sum() == 8
    assert all(fmats[k].tobytes() == mats[k].tobytes() for k in mats)
    assert len(fmips) == len(mips) and all(a.tobytes() == b.tobytes() for fa, wa in zip(fmips, mips)
                                           for a, b in zip(fa, wa))


def test_kind_inputs_are_the_torus_fields_with_the_glass_classes(root):
    import run as fb_run

    _, _, config, mix, _ = fb_run.load_cell(CELL, root)
    kind, _, _ = fb_run.cell_hooks(config, mix, root)
    torus = fb_run.cell_hooks(dict(config, kind="torus_field"), mix, root)[0]
    x, t = kind.make_inputs(config, SEED), torus.make_inputs(config, SEED)
    for k in t.draws:
        if k != "post_pass":
            assert x.draws[k].tobytes() == t.draws[k].tobytes(), k
    glass = x.draws["material_index"] == 6
    assert (x.draws["post_pass"][glass] == 2).all()
    assert (x.draws["post_pass"][~glass] == t.draws["post_pass"][~glass]).all()
    assert x.materials["textures"][:4, 1].tolist() == [8] * 4 and (x.materials["textures"][4:, 1] == -1).all()
    assert len(x.mips) == 9


# ---- the cell, sound and with faults ----

def test_tiny_glass_cell_is_correct(root):
    """run.run on the CPU in a process of its own: this one holds JAX (the
    tests' conftest), which a run refuses to have loaded."""
    import subprocess

    code = (f"import json, sys; sys.path[:0] = [{FB!r}, {REPO!r}]; import torch; torch.set_num_threads(1); "
            f"import tinyrun; res, _ = tinyrun.run({root!r}, {CELL!r}, seed={SEED}, trace=1); print(json.dumps(res))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert {"layer_geom", "layer_visible", "layer_missed", "layer_image", "layer_behind", "normal"} <= set(checks)
    assert checks["layer_geom"] > 0 and checks["layer_image"] > 0, "the layer is in front nowhere"
    m = res["metrics"]
    assert m["layer_ms"]["value"] > 0 and 0 <= m["layer_headroom_pct"]["value"] <= 100
    # no device trace on the CPU: the idle reader finds nothing and is left out
    assert "layer_idle_ms" not in m


def _edited(mod, name: str, old: str, new: str):
    """mod.`name` recompiled from its source with `old` replaced by `new`
    once, in a copy of the module's namespace."""
    src = inspect.getsource(getattr(mod, name))
    assert src.count(old) == 1, (name, old)
    ns = dict(vars(mod))
    exec(compile(src.replace(old, new), inspect.getsourcefile(mod), "exec"), ns)
    return ns[name]


def _wrapped(fn, **over):
    def call(*a, **kw):
        return fn(*a, **dict(kw, **over))
    return call


def _late_classes_below_glass(fn):
    def call(*a, num_classes=None, **kw):
        return fn(*a, num_classes=None if num_classes is None else min(num_classes, 2), **kw)
    return call


# each fault: the port's function it replaces, and the kind's number that
# has to catch it (None: none does; the field's centre is in shadow from
# every draw, so glass in the sun map darkens nothing more, PERF.md §7)
FAULTS = {
    "blend dropped": (lambda: (shade, "composite", _edited(shade, "composite", "if transmission is not None:",
                                                           "if False:")), "layer_image"),
    "blend behind": (lambda: (shade, "composite", _edited(shade, "composite",
                                                          "t_front = valid_t & ((depth_t > depth) | ~valid)",
                                                          "t_front = valid_t")), "layer_behind"),
    "group culled": (lambda: (cull, "cull_draws", _late_classes_below_glass(cull.cull_draws)), "layer_geom"),
    "maps ignored": (lambda: (shade, "gbuffer_from_attrs", _wrapped(shade.gbuffer_from_attrs, depth=None)),
                     "normal"),
    "glass in sun map": (lambda: (sunmap, "sun_cull", _edited(sunmap, "sun_cull", " & (scene.draw_post_pass != 2)",
                                                              "")), None),
}


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` planted in the port for the block."""
    mod, attr, fn = FAULTS[name][0]()
    real = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def fault_readings(root: str, seed: int, dev, names=tuple(FAULTS)) -> dict:
    """Every compared number of the frame a run checks, sound and with
    each fault planted (the sun map rebuilt under its own), against one
    reference frame."""
    import control
    import run as fb_run
    from core import check, hooks, reference, renderer

    _, _, config, mix, _ = fb_run.load_cell(CELL, root)
    kind, cam, motion = fb_run.cell_hooks(config, mix, root)
    x = kind.make_inputs(config, seed)
    prog = renderer.Renderer(config, mix, x, kind.program_geometry(config, os.path.join(root, ".cache", "fb")), dev,
                             seed, cam, motion)
    k = control.checked_frame(mix, seed)
    state = prog.init_state()
    for i in range(k):
        state = prog.step(i, state)["state"]
    extra = hooks.kind_hook(kind, "program_extra")

    def view():
        cap = {}
        out = prog.step(k, state, capture=cap)
        pv = check.program_view(out, cap, float(config["camera"]["znear"]), prog.frame)
        return pv, extra(out, cap, config)

    views = {"sound": view()}
    for name in names:
        with planted(name):
            sun = prog.sun
            if name == "glass in sun map":
                prog._build_sun_map(x)
            views[name] = view()
            prog.sun = sun
    prog.free()
    ref = reference.render(config, mix, kind, x, k, seed, dev, cam, motion)
    px = check.pixel_size(config)
    return {n: dict(check.compare(pv, ref, px), **check.compare_extra(kind, pe, ref, px))
            for n, (pv, pe) in views.items()}


@pytest.fixture(scope="module")
def faults(root):
    return fault_readings(root, SEED, CPU)


@pytest.mark.parametrize("name", [n for n, (_, number) in FAULTS.items() if number])
def test_planted_fault_fails_its_number(root, faults, name):
    with open(os.path.join(root, "framebench", "limits", f"{CELL}.json")) as f:
        limits = json.load(f)
    number = FAULTS[name][1]
    sound = faults["sound"]
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert faults[name][number] > limits[number], (name, faults[name])


# ---- what the reference imports ----

def test_reference_imports_nothing_of_the_port(root):
    """ref/glass.py and data/glass_field.py import no module of the port,
    the JAX package or JAX; the kind's reference hooks pass kind_hook's
    guard (which refuses a kind holding anything of the port)."""
    import run as fb_run
    from core import hooks

    banned = {"niagara_tpu", "niagara_tpu_torch", "jax", "jaxlib", "flax"}
    for rel in ("ref/glass.py", "data/glass_field.py"):
        tree = ast.parse(open(os.path.join(FB, rel)).read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
            assert not {m.split(".")[0] for m in mods} & banned, (rel, mods)
    _, _, config, mix, _ = fb_run.load_cell(CELL, root)
    kind = fb_run.cell_hooks(config, mix, root)[0]
    assert hooks.program_globals(vars(kind)) == []
    for name in hooks.REFERENCE_HOOKS[1:]:
        assert hooks.kind_hook(kind, name) is not None


# ---- the span and the counter ----

W, H = 256, 128
CAPS = presets.small_capacities()


@pytest.fixture(scope="module")
def small():
    g = cooker.cook_procedural()
    out = {}
    for passes, make in ((3, cooker.small_glass_scene), (2, cooker.small_alpha_scene)):
        ga, da, mats, masks, mips = make(g)
        table = textures.build_texture_table(mips)
        out[passes] = types.SimpleNamespace(
            scene=scene.from_numpy(scene.upload(ga, da, mats, masks, texture_table=table), "cpu"),
            table=textures.to_device(table, "cpu"), cfg=frame.FrameConfig(width=W, height=H, post_passes=passes,
                                                                          **CAPS))
    return out


def _frame(s, state, stages=None, capture=None):
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), s.cfg)
    return frame.render_frame(s.scene, state, params, sp, s.cfg, textures=s.table, stages=stages, capture=capture)


@pytest.mark.parametrize("passes", [3, 2])
def test_layer_span_and_counter_only_with_the_layer(small, passes):
    s = small[passes]
    state = frame.init_state(s.scene.num_draws, s.scene.meshlet_visibility_count, "cpu")
    state = _frame(s, state)[2]
    timer = StageTimer("cpu")
    timer.begin()
    cap = {}
    _frame(s, state, stages=timer, capture=cap)
    (f,) = timer.resolve()
    names = [r[0] for r in f["stages"]]
    assert ("layer G-buffer" in names) == ("glass clusters" in f["counters"]) == (passes == 3)
    if passes == 3:
        assert names.index("layer setup+raster") < names.index("shade") < names.index("layer G-buffer") \
            < names.index("G-buffer")
        (tc, _), = [sc for name, sc in zip(cap["passes"], cap["setup"]) if name == "glass"]
        assert f["counters"]["glass clusters"] == ((int(tc["count"][0]),), (s.cfg.late_cluster_cap,))
        assert int(tc["count"][0]) > 0
        assert {"g1", "attrs"} <= set(cap) and {"depth", "vis", "valid"} <= set(cap["layer"])
    else:
        assert cap["layer"] is None


def test_untraced_layer_span_records_and_launches_nothing(small, monkeypatch):
    """Without a StageTimer and the profiler the glass frame enters
    record_function 0 times and counts nothing; with one it dispatches the
    same operations (the boundaries' host clock aside)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    s = small[3]
    state = frame.init_state(s.scene.num_draws, s.scene.meshlet_visibility_count, "cpu")
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    count = StageTimer.count
    monkeypatch.setattr(StageTimer, "count", lambda *a, **kw: pytest.fail("an untraced frame counted"))
    with Ops() as plain:
        image = _frame(s, state)[0]
    assert entered == []
    monkeypatch.setattr(StageTimer, "count", count)
    timer = StageTimer("cpu")
    timer.begin()
    with Ops() as timed:
        timed_image = _frame(s, state, stages=timer)[0]
    assert torch.equal(image, timed_image)
    assert sorted(plain.ops) == sorted(timed.ops)


# ---- the readers ----

def _reader(name):
    from core import hooks

    return hooks.load(REPO, "metrics", name).read


def _run(stages=None, trace=None):
    return types.SimpleNamespace(stages=stages, trace=trace, work=None)


def test_layer_ms_reads_the_layer_spans():
    frames = [dict(stages=[("shade", 1.0, 0.1), ("layer setup+raster", 2.0, 0.2), ("layer G-buffer", 0.5, 0.1),
                           ("G-buffer", 3.0, 0.1)], counters={}),
              dict(stages=[("layer setup+raster", 4.0, 0.2), ("layer G-buffer", 1.5, 0.1)], counters={})]
    assert _reader("layer_ms")(_run(frames)) == pytest.approx((2.5 + 5.5) / 2)
    assert _reader("layer_ms")(_run([dict(stages=[("G-buffer", 3.0, 0.1)], counters={})])) is None
    assert _reader("layer_ms")(_run()) is None


def test_layer_headroom_reads_the_glass_counters():
    frames = [dict(stages=[], counters={"glass pairs": ((30,), (100,)), "glass pair classes": ((1, 2), (10, 4)),
                                        "glass clusters": ((10,), (40,)), "late pairs": ((99,), (100,))}),
              dict(stages=[], counters={"glass clusters": ((36,), (40,))})]
    assert _reader("layer_headroom_pct")(_run(frames)) == pytest.approx(10.0)
    assert _reader("layer_headroom_pct")(_run([dict(stages=[], counters={"late pairs": ((1,), (2,))})])) is None
    assert _reader("layer_headroom_pct")(_run()) is None


def test_layer_idle_reads_the_idle_under_the_layer_spans():
    ops = [("niagara::layer setup+raster", 0.0, 100.0), ("niagara::layer G-buffer", 100.0, 50.0),
           ("niagara::G-buffer", 150.0, 50.0)]
    # the device: busy 0-40, 120-130 and 160-200; idle 40-120 (80 under the
    # layer's spans), 130-160 (20 under "layer G-buffer", 10 under "G-buffer")
    events = [("k", None, 0.0, 40.0), ("k", None, 120.0, 10.0), ("k", None, 160.0, 40.0)]
    trace = types.SimpleNamespace(host_ops=ops, events=events, window_s=200e-6, frames=2)
    assert _reader("layer_idle_ms")(_run(trace=trace)) == pytest.approx(100.0e-3 / 2)
    bare = types.SimpleNamespace(host_ops=[("niagara::G-buffer", 0.0, 10.0)], events=events, window_s=200e-6,
                                 frames=1)
    assert _reader("layer_idle_ms")(_run(trace=bare)) is None
    assert _reader("layer_idle_ms")(_run()) is None
