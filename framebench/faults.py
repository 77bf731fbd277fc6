"""The faults of `correct`, read at a cell's own size: the program renders
the frame a run would check, then that frame again with one fault planted
where its output is produced, and the cell's comparison (core/check.py)
reads each against the reference.  The benchmark's own runs do not run it;
test_framebench_run.py plants the same faults in whole runs on the CPU.
One JSON line a seed:

    python3 framebench/faults.py --workload <cell> --seeds <n> [<n> ...]

Faults: `state` (the visibility state handed on unchanged, so it stays at
its cold start), `half` (half of the draws left out), `image` (the image
altered: +0.25 in green), `shadow` (the sun term left at 1, unshadowed),
and with a sun-map update `stale` (the band not updated: the tail's
shadows stay at rest).  A configuration kind's own numbers are read
beside the harness's (each fault keeps the sound frame's `program_extra`,
but `half`, which renders anew).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload: str, seed: int, dev, root: str = ROOT) -> dict:
    import torch

    import control
    import run as fb_run
    from core import check, hooks, reference, renderer

    _, _, config, mix, _ = fb_run.load_cell(workload, root)
    kind, camera, motion = fb_run.cell_hooks(config, mix, root)
    x = kind.make_inputs(config, seed)
    prog = renderer.Renderer(config, mix, x, kind.program_geometry(config, os.path.join(root, ".cache", "framebench")),
                             dev, seed, camera, motion)
    k = control.checked_frame(mix, seed)
    state = prog.init_state()
    for i in range(k):
        state = prog.step(i, state)["state"]
    znear = float(config["camera"]["znear"])

    program_extra = hooks.kind_hook(kind, "program_extra")

    def view(**kw):
        cap = {}
        out = prog.step(k, state, capture=cap, **kw)
        pv = check.program_view(out, cap, znear, prog.frame)
        return pv if program_extra is None else dict(pv, extra=program_extra(out, cap, config))

    sun_frame = prog.sun_frame()
    views = {"sound": view()}
    pv = views["sound"]
    views["state"] = dict(pv, draw_vis=torch.zeros_like(pv["draw_vis"]))
    views["image"] = dict(pv, color=pv["color"] + torch.tensor([0.0, 0.25, 0.0], device=dev))
    if pv["sun"] is not None:
        views["shadow"] = dict(pv, sun=torch.ones_like(pv["sun"]))
    ds = prog.ds
    n = ds.num_draws // 2
    pos, xf = ds.draw_position.clone(), ds.draw_xform_row.clone()
    pos[n:] += 1e6
    xf[n:, 0:3] += 1e6
    prog.ds = dataclasses.replace(ds, draw_position=pos, draw_xform_row=xf)
    views["half"] = view()
    prog.ds = ds
    if prog.tail is not None:
        prog.tail_update = lambda i, stages=None, capture=None: (prog.sun[1], torch.zeros((), device=dev))
        views["stale"] = view()
    prog.free()
    del state
    torch.cuda.empty_cache()
    ref = reference.render(config, mix, kind, x, k, seed, dev, camera, motion)
    out = {name: check.compare(v, ref, check.pixel_size(config)) | check.compare_extra(
        kind, v.get("extra"), ref, check.pixel_size(config)) for name, v in views.items()}
    if sun_frame is not None:
        band = reference.sun_band(config, mix, kind, x, k, seed, dev, motion, sun_frame)
        for name, v in views.items():
            out[name]["sunmap"] = check.compare_sun_band(v["sun_map"][band[0]], band, sun_frame)
    return out | {"counts": dict(check.COUNTS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 framebench/faults.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    opts = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".cache", "framebench", sub)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("faults.py: no CUDA card", file=sys.stderr)
        return 1
    from niagara_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    for seed in opts.seeds:
        t0 = time.perf_counter()
        r = readings(opts.workload, seed, dev)
        print(json.dumps(dict(workload=opts.workload, seed=seed, seconds=time.perf_counter() - t0, **r)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
