"""A configuration's kind may bring its own reference and its own compared
numbers (kinds/<kind>.py `reference_scene`, `reference_render`,
`program_extra`, `compare_extra`): run.py and control.py find them by the
kind's name, with no edit outside the kind's files; a kind without them
gets ref.frame's frame; a number the kind adds is held to the cell's
limit, and has to have one; a kind's reference that imports the program
is refused.

    python -m pytest framebench -q
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import tinyrun

CPU = torch.device("cpu")
KIND = "torus_hooked"
CELL = f"{KIND}.still"

# the harness's reference, wrapped: each call noted in calls.jsonl beside
# the kind, and the frame's covered share carried as its `extra`
RENDER = '''

import json as _json
import os as _os

import torch as _torch

from core import reference as _reference

CALLS = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "calls.jsonl")


def reference_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=_torch.float32, at=None):
    with open(CALLS, "a") as f:
        f.write(_json.dumps({"dtype": str(dtype), "at": at is not None}) + "\\n")
    frame = _reference.base_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=dtype, at=at)
    frame.extra = {"covered": float(_torch.isfinite(frame.w).float().mean())}
    return frame
'''

# a further number: how far the program's covered share departs from the
# reference's
EXTRA = '''

def program_extra(out, capture, config):
    from niagara_tpu_torch.ops.raster import INVALID_FRAG

    fb = out["fb"]
    covered = (fb.vis.reshape(-1) != INVALID_FRAG) & (fb.depth.reshape(-1) > 0)
    return {"covered": float(covered.float().mean())}


def compare_extra(p_extra, ref, pixel):
    return {"coverage_gap": abs(p_extra["covered"] - ref.extra["covered"])}
'''

IMPORTS_INSIDE = '''

def reference_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=None, at=None):
    from niagara_tpu_torch.ops import raster  # noqa: F401

    raise AssertionError("not reached")
'''

IMPORTS_AT_TOP = '''

from niagara_tpu_torch.ops import raster as _raster  # noqa: E402


def reference_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=None, at=None):
    raise AssertionError("not reached")
'''


def kind_root(tmp_path, hooks_text: str, limits: dict | None) -> str:
    """A tiny benchmark tree with the cell `torus_hooked.still`: the torus
    configuration under a kind that is kinds/torus_field.py with
    `hooks_text` after it, a fixed camera, no shadows; its limits
    TINY_LIMITS and `limits`."""
    root = tinyrun.make_root(str(tmp_path))
    fb = os.path.join(root, "framebench")
    with open(os.path.join(fb, "configs", "torus_1m.json")) as f:
        config = json.load(f)
    with open(os.path.join(fb, "configs", f"{KIND}.json"), "w") as f:
        json.dump(dict(config, kind=KIND), f)
    shutil.copy(os.path.join(tinyrun.HERE, "kinds", "torus_field.py"), os.path.join(fb, "kinds", f"{KIND}.py"))
    with open(os.path.join(fb, "kinds", f"{KIND}.py"), "a") as f:
        f.write(hooks_text)
    with open(os.path.join(fb, "traffic", "still.json"), "w") as f:
        json.dump({"camera": "fixed", "shadows": "none", "warmup_frames": 1}, f)
    if limits is not None:
        with open(os.path.join(fb, "limits", f"{CELL}.json"), "w") as f:
            json.dump(dict(tinyrun.TINY_LIMITS, **limits), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name=KIND, file=f"framebench/configs/{KIND}.json"))
    b["workloads"].append({"name": CELL, "config": KIND, "traffic": "still", "chips": 1,
                           "why": "a kind with its own reference"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


def calls(root) -> list:
    path = os.path.join(root, "framebench", "kinds", "calls.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kind_without_hooks_gets_ref_frame(tmp_path, dtype):
    """The torus kind brings no reference: core.reference.render gives
    ref.frame's frame, equal field for field to a direct call."""
    import run as fb_run
    from core import reference
    from ref import frame as ref_frame

    root = tinyrun.make_root(str(tmp_path))
    _, _, config, mix, _ = fb_run.load_cell("torus_1m.rt", root)
    kind, camera, motion = fb_run.cell_hooks(config, mix, root)
    x = kind.make_inputs(config, 5)
    got = reference.render(config, mix, kind, x, 4, 5, CPU, camera, motion, dtype=dtype)

    sc = ref_frame.Scene.build(kind.reference_levels(config), x.draws, x.materials, x.mips, CPU)
    pos, orient = camera.camera(4, 5, mix)
    cam = ref_frame.Camera(position=torch.as_tensor(pos), orientation=torch.as_tensor(orient),
                           fov_y=float(np.radians(config["camera"]["fov_y_degrees"])),
                           znear=float(config["camera"]["znear"]))
    sun = np.asarray(config["sun_direction"], np.float64)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    want = ref_frame.render(sc, cam, config["width"], config["height"], config["draw_distance"], sun,
                            reference.samples(config, 5, CPU), shadows=True, dtype=dtype)
    assert type(got) is ref_frame.Frame
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_kind_reference_and_numbers_reach_run_and_control(tmp_path):
    """run.py renders the checked frame by the kind's reference_render and
    holds its `coverage_gap` to the cell's limit; control.py calls the same
    reference, in float32 and then in bfloat16 at its samples, and reports
    the kind's number too."""
    import control

    root = kind_root(tmp_path, RENDER + EXTRA, {"coverage_gap": 0.5})
    res, checks = tinyrun.run(root, CELL)
    assert res["correct"] is True, checks
    assert checks["coverage_gap"][1] == 0.5 and 0.0 < checks["coverage_gap"][0] < 0.5, checks
    assert res["checks"]["coverage_gap"] == {"value": checks["coverage_gap"][0], "limit": 0.5}
    assert calls(root) == [{"dtype": "torch.float32", "at": False}]

    readings = control.readings(CELL, 5, CPU, root)
    assert calls(root)[1:] == [{"dtype": "torch.float32", "at": False}, {"dtype": "torch.bfloat16", "at": True}]
    assert 0.0 <= readings["coverage_gap"] < 1.0 and {"geom", "visible", "missed"} <= set(readings)


def test_kind_number_over_its_limit_is_not_correct(tmp_path):
    """The same kind with the limit of `coverage_gap` under its reading: the
    run reads `correct` false."""
    root = kind_root(tmp_path, RENDER + EXTRA, {"coverage_gap": 0.0})
    res, checks = tinyrun.run(root, CELL)
    assert checks["coverage_gap"][0] > 0.0 and res["correct"] is False, checks
    assert all(v <= lim for k, (v, lim) in checks.items() if k != "coverage_gap"), checks


def test_kind_number_without_a_limit_ends_the_run(tmp_path):
    """A number the kind adds that the cell's limits do not name ends the
    run with an error: it is never read as passing."""
    root = kind_root(tmp_path, RENDER + EXTRA, {})
    with pytest.raises(SystemExit, match="coverage_gap.*no limit"):
        tinyrun.run(root, CELL)


@pytest.mark.parametrize("where", ["inside", "at_top"])
def test_kind_reference_importing_the_program_is_refused(tmp_path, where):
    """A reference_render that imports the program, in its body or beside
    it at the top of the kind's file, ends the run."""
    root = kind_root(tmp_path, IMPORTS_INSIDE if where == "inside" else IMPORTS_AT_TOP, {})
    with pytest.raises(SystemExit, match="nothing of niagara_tpu_torch"):
        tinyrun.run(root, CELL)
