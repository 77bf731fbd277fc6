"""A new configuration (with a kind of its own), traffic mix (with a motion
and a moving camera of its own) and per-layer metric are files of their
own, found by name from BENCHMARK.json's entries: adding them edits no
file that is there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import tinyrun

MOTION = '''"""Every moving draw rises by 0.1 a frame."""

import torch


def positions(rest, i, mix):
    return rest + torch.tensor([0.0, 0.1 * (i + 1), 0.0], device=rest.device)
'''

CAMERA = '''"""A camera that turns 1 degree a frame about the vertical and moves 0.05
forward a frame."""

import math

import numpy as np


def camera(i, seed, mix):
    a = math.radians(1.0 * i) / 2.0
    q = np.array([0.0, math.sin(a), 0.0, math.cos(a)], np.float32)
    fwd = np.array([-math.sin(2 * a), 0.0, -math.cos(2 * a)], np.float32)
    return (0.05 * i * fwd).astype(np.float32), q
'''

METRIC = "def read(run):\n    return float(len(run.stages))\n"


def digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            if ".cache" not in path and name != "BENCHMARK.json":
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_new_files_add_a_cell_and_a_metric(tmp_path):
    root = tinyrun.make_root(str(tmp_path))
    fb = os.path.join(root, "framebench")
    before = digest(root)
    with open(os.path.join(fb, "configs", "torus_1m.json")) as f:
        config = json.load(f)
    write(os.path.join(fb, "configs", "torus_small.json"), json.dumps(dict(config, kind="torus_copy", draws=300)))
    shutil.copy(os.path.join(tinyrun.HERE, "kinds", "torus_field.py"), os.path.join(fb, "kinds", "torus_copy.py"))
    write(os.path.join(fb, "motions", "rise.py"), MOTION)
    write(os.path.join(fb, "cameras", "turn.py"), CAMERA)
    write(os.path.join(fb, "traffic", "flyby.json"), json.dumps(
        {"camera": "turn", "motion": "rise", "tail_share": 0.1, "shadows": "none", "warmup_frames": 1}))
    write(os.path.join(fb, "limits", "torus_small.flyby.json"), json.dumps(tinyrun.TINY_LIMITS))
    write(os.path.join(fb, "metrics", "frames_traced.py"), METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="torus_small", file="framebench/configs/torus_small.json"))
    b["workloads"].append({"name": "torus_small.flyby", "config": "torus_small", "traffic": "flyby", "chips": 1,
                           "why": "a cell added as files"})
    b["per_layer"].append({"name": "frames_traced", "unit": "count", "better": "higher", "source": "program_span",
                           "layer": "frame loop", "moves": "frame_ms", "workloads": ["torus_small.flyby"]})
    write(os.path.join(root, "BENCHMARK.json"), json.dumps(b))
    res, checks = tinyrun.run(root, "torus_small.flyby", seconds=1.5, trace=1)
    assert res["correct"] is True, checks
    assert res["metrics"]["frames_traced"]["value"] == res["attempted"] > 1
    assert "sunmap_update_ms" not in res["metrics"] and "shadow_ms.sunmap" not in res["metrics"]
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
