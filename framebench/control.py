"""The control of `correct` at a cell's own size: the reference with its
vertex transform in bfloat16, the precision below the float32 the
configuration states, put in the program's place and compared with the
float32 reference by the cell's own comparison (core/check.py; the
configuration kind's own reference and numbers where it brings them: its
`compare_extra` gets the control frame's `extra` with `at`, its samples).
A later change that moved the transform to 16-bit floats would render
this way; its readings have to fail the cell's limits.  The benchmark's own runs do
not run it.  One JSON line a seed, for the frame a run would check:

    python3 framebench/control.py --workload <cell> --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def checked_frame(mix: dict, seed: int) -> int:
    """The index of the frame a run checks (run.py: the cold start, the
    warm-up frames, then the window's frame drawn from the seed)."""
    import numpy as np

    import run as fb_run

    k = int(np.random.default_rng([seed % (1 << 63), 1]).integers(0, fb_run.SAMPLE_RANGE))
    return 1 + mix["warmup_frames"] + k


def readings(workload: str, seed: int, dev, root: str = ROOT) -> dict:
    import torch

    import run as fb_run
    from core import check, reference

    _, _, config, mix, _ = fb_run.load_cell(workload, root)
    kind, camera, motion = fb_run.cell_hooks(config, mix, root)
    x = kind.make_inputs(config, seed)
    i = checked_frame(mix, seed)
    ref = reference.render(config, mix, kind, x, i, seed, dev, camera, motion)
    ctl = reference.render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=torch.bfloat16, at=ref.samples)
    out = check.compare(check.reference_view(ctl), ref, check.pixel_size(config))
    out.update(check.compare_extra(kind, dict(getattr(ctl, "extra", {}), at=ctl.samples), ref,
                                   check.pixel_size(config)))
    return dict(out, counts=dict(check.COUNTS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 framebench/control.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    opts = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in opts.seeds:
        t0 = time.perf_counter()
        r = readings(opts.workload, seed, dev)
        print(json.dumps(dict(workload=opts.workload, seed=seed, seconds=time.perf_counter() - t0, **r)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
