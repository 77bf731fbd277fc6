"""A tiny copy of the benchmark for the CPU tests: BENCHMARK.json and the
traffic mixes as they are, the torus configuration cut to 400 draws (the
last 8 the animated tail) in a 12-unit cube at 256x128 with small budgets
and a 256x256 sun map.  Runs go through run.run on the CPU, which skips the look for a card; the program
then takes its plain torch versions, as the reference does."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_CAPS = dict(cmd_capacity=1 << 8, cluster_capacity=1 << 11, candidate_capacity=1 << 12,
                  late_candidate_capacity=1 << 12, pair_capacity=1 << 15, tri_capacity=1 << 15,
                  late_cluster_capacity=1 << 10, late_tri_capacity=1 << 13)
SMALL_SUN = dict(size=256, batch=128, caps=dict(cmd_capacity=1 << 10, cluster_capacity=1 << 12,
                                                tri_capacity=1 << 16, pair_capacity=1 << 17))
# the limits at this size, from its sound readings (geom 0.27, image 0.17,
# shadow 0.03-0.07, visible 0.013, missed 0, sunmap 0.11 with a quarter of the
# draws moving): 256x128 pixels are coarse
# next to the tori, so the levels of detail and the textures' aliasing
# differ over more of the frame than at 1080p
TINY_LIMITS = dict(replay=0.0, geom=0.4, image=0.3, shadow=0.2, visible=0.05, missed=0.02, sunmap=0.3)
SMALL_UPDATE = dict(cmd_capacity=1 << 8, cluster_capacity=1 << 10, tri_capacity=1 << 14, pair_capacity=1 << 15)


def make_root(dest: str) -> str:
    """A benchmark tree under `dest`: BENCHMARK.json and framebench/ copied
    (ref/, core/ and data/ are imported from the repository), the torus
    configuration and the mixes' budgets cut down, and the cells' limits
    set to TINY_LIMITS."""
    fb = os.path.join(dest, "framebench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for sub in ("configs", "traffic", "metrics", "limits", "kinds", "cameras", "motions"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(fb, sub))
    path = os.path.join(fb, "configs", "torus_1m.json")
    with open(path) as f:
        c = json.load(f)
    c.update(samples=2048, draws=400, scatter_range=12.0, width=256, height=128, capacities=SMALL_CAPS,
             sun_map=SMALL_SUN)
    with open(path, "w") as f:
        json.dump(c, f)
    for name in os.listdir(os.path.join(fb, "traffic")):
        path = os.path.join(fb, "traffic", name)
        with open(path) as f:
            m = json.load(f)
        if "update_caps" in m:
            m["update_caps"] = SMALL_UPDATE
        m["warmup_frames"] = 1
        with open(path, "w") as f:
            json.dump(m, f)
    for name in os.listdir(os.path.join(fb, "limits")):
        with open(os.path.join(fb, "limits", name), "w") as f:
            json.dump(TINY_LIMITS, f)
    return dest


def run(root: str, workload: str = "torus_1m.anim", seed: int = 5, seconds: float = 0.5, trace: int = 0):
    """One run on the CPU: (result, compared numbers)."""
    import torch

    import run as fb_run

    opts = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    return fb_run.run(opts, dev=torch.device("cpu"), root=root)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        res, _ = run(make_root(tmp), *sys.argv[1:2])
        print(json.dumps(res))
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
