"""The harness end to end on the CPU at a tiny size (tinyrun.py): the last
line's keys, `correct` against the independent reference, the faults that
have to turn it false, the control, and what a run loads.

    python -m pytest framebench -q
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import tinyrun

FORBIDDEN = {"jax", "jaxlib", "flax", "niagara_tpu"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyrun.make_root(str(tmp_path_factory.mktemp("fb")))


def bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_result_line_trace0(root):
    res, _ = tinyrun.run(root, "torus_1m.anim", trace=0)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0, res["checks"]
    names = {m["name"] for m in bench(root)["end_to_end"]}
    assert set(res["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert set(res["checks"]) == {"replay", "geom", "image", "shadow", "sunmap", "visible", "missed", "setup_drops"}


def test_result_line_trace1(root):
    res, _ = tinyrun.run(root, "torus_1m.anim", trace=1)
    assert res["correct"] is True, res["checks"]
    per = {m["name"] for m in bench(root)["per_layer"]}
    assert set(res["metrics"]) <= per
    # the CPU has no device trace: the stage spans are read, the trace's
    # metrics are left out, never reported as 0
    for name in ("host_ms", "cull_ms", "raster_ms", "gbuffer_ms", "bloom_ms", "sunmap_update_ms",
                 "shadow_ms.sunmap"):
        assert res["metrics"][name]["value"] > 0
    for name in ("setup_roofline", "raster_roofline", "idle_pct", "launches_per_frame", "shadow_ms.rt"):
        assert name not in res["metrics"]


def _patched_render(monkeypatch, fault):
    from niagara_tpu_torch.ops import sunmap
    from niagara_tpu_torch.render import frame

    original = frame.render_frame
    if fault == "shadow":
        monkeypatch.setattr(sunmap, "shadow_map_pass", lambda depth, *a, **kw: torch.ones_like(depth))

    def render(scene, state, params, sp, cfg, **kw):
        if fault == "half":
            n = scene.num_draws // 2
            pos = scene.draw_position.clone()
            xf = scene.draw_xform_row.clone()
            pos[n:] += 1e6
            xf[n:, 0:3] += 1e6
            scene = dataclasses.replace(scene, draw_position=pos, draw_xform_row=xf)
        image, fb, new_state, stats = original(scene, state, params, sp, cfg, **kw)
        if fault == "state":
            new_state = state
        elif fault == "image":
            image = image.clone()
            image[..., 1] += 0.25
        return image, fb, new_state, stats

    monkeypatch.setattr(frame, "render_frame", render)


@pytest.mark.parametrize("fault", ["state", "half", "image", "shadow"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    """A frame that returns its visibility state unchanged, one that leaves
    half of the draws out, one whose image is altered where it is produced,
    and one whose sun term is left unshadowed: each run reads `correct`
    false."""
    _patched_render(monkeypatch, fault)
    res, checks = tinyrun.run(root, "torus_1m.anim", trace=0)
    assert res["correct"] is False, checks


def test_stale_sun_band_is_not_correct(tmp_path, monkeypatch):
    """The sun map's band left at the tail's rest (the update's result
    dropped): the map still holds the tail where it was, and `sunmap` says
    so.  A quarter of the draws move, so that the tiny map has such
    texels."""
    from core import renderer

    root = tinyrun.make_root(str(tmp_path))
    path = os.path.join(root, "framebench", "traffic", "anim.json")
    with open(path) as f:
        mix = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(mix, tail_share=0.25), f)
    res, checks = tinyrun.run(root, "torus_1m.anim", trace=0)
    assert res["correct"] is True, checks
    monkeypatch.setattr(renderer.Renderer, "tail_update", lambda self, i, stages=None, capture=None:
                        (self.sun[1], torch.zeros((), dtype=torch.int64)))
    res, checks = tinyrun.run(root, "torus_1m.anim", trace=0)
    assert res["correct"] is False and checks["sunmap"][0] > checks["sunmap"][1], checks


@pytest.mark.parametrize("workload", ["torus_1m.anim", "torus_1m.rt"])
def test_control_is_not_correct(tmp_path, workload):
    """The reference with its vertex transform in bfloat16, in the
    program's place, fails one of the cell's limits.  The draws spread
    over a 300-unit cube, where bfloat16's rounding moves them as in the
    full configuration (the program does not run here)."""
    import control

    root = tinyrun.make_root(str(tmp_path))
    path = os.path.join(root, "framebench", "configs", "torus_1m.json")
    with open(path) as f:
        config = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(config, draws=4000, scatter_range=150.0), f)
    readings = control.readings(workload, 5, torch.device("cpu"), root)
    limits = tinyrun.TINY_LIMITS
    assert any(v > limits[k] for k, v in readings.items() if k in limits), readings


def test_run_loads_no_jax(root):
    """After a tiny run no module's top-level name is jax, jaxlib, flax or
    niagara_tpu (the part before the first dot, compared whole:
    niagara_tpu_torch is the port)."""
    out = subprocess.run([sys.executable, tinyrun.__file__, "torus_1m.rt"], capture_output=True, text=True,
                         timeout=600, cwd=tinyrun.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res, names = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert res["correct"] is True, res["checks"]
    assert "niagara_tpu_torch" in names and not FORBIDDEN & set(names)
