"""Time variants of the port's BVH walk (csrc/trace.cu) on one GPU, each in
turns with another tree's walk on the same rays.  From the repository's
root:

    python3 -m niagara_tpu_torch.trace_sweep --baseline DIR [--other DIR ...] [--reps N]

DIR holds another tree of the repository (e.g. an earlier commit unpacked
by `git archive` into the ignored .cache/), whose ops/shadow.py trace_cuda
is the yardstick.  The rays are those of the benchmark's ray-traced frames
(chip_smoke.py's "rt" and "rt alpha" paths): the procedural torus's
1,000,000 draws by the reference's PCG scatter at 1920x1080, rendered four
frames from a cold state with ray-traced shadows (the alpha scene with the
quality-1 any-hit), the last frame's shadow_pass rays captured.  On them,
for trace_any_hit<false> and <true>:

  - the baseline tree's kernel in id order, and on the rays permuted into
    shadow.ray_order in the glue (the ray order alone);
  - this tree's kernel as built (the Morton pixel order, as many blocks
    as fill the card once), then one setting changed at a time: the ray
    order (id order; origins in Morton order of a 2^10 grid over their
    bounding box, or the most steps first, sorted in the glue, the sort's
    own time added), `blocks`, each schedule constant of trace.cu in
    CONSTANTS (a copy of trace.cu with that one value changed, built
    alone, one nvcc each, all at once; ptxas's registers and spills
    printed), and the trace_cuda of each `--other` tree;
  - the rays over 512 steps and the rest, each set alone, and the whole
    set under a 256-step budget (against trace_plain under it);

each checked against trace_plain flag for flag and step for step, then
timed (CUDA events behind a spin kernel, chip_smoke.in_turns: baseline,
variant, variant, baseline, `--reps` launches each).  One line a variant;
every row also goes to chiprun_out/trace_sweep.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

import chip_smoke
from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import shadow
from niagara_tpu_torch.render import camera, frame, presets, textures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# trace.cu's schedule constants and the values tried beside the built ones
# (refill 8, batch 4, tail 8, minimum blocks 1)
CONSTANTS = {"kRefill": (1, 4, 16, 32), "kBatch": (1, 2, 8), "kTail": (0, 1, 2, 4, 16), "kMinBlocks": (8, 12)}


def build_variants(values: dict) -> dict:
    """A copy of trace.cu for each (constant, value) of `values`, that one
    `constexpr int` changed, built alone into the build directory, one
    nvcc each, all at once: {label: (the library with trace_launch bound,
    ptxas's lines)}."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "trace.cu")) as f:
        src = f.read()
    procs = {}
    for name, value in values:
        label = f"{name} {value}"
        edited, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"trace.cu declares {name} {count} times, not once")
        stem = os.path.join(_build.BUILD_DIR, f"trace_{name}_{value}")
        with open(stem + ".cu", "w") as f:
            f.write(edited)
        procs[label] = stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for label, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        lib.trace_launch.argtypes = _build._SIGNATURES["trace_launch"]
        lib.trace_launch.restype = ctypes.c_int
        out[label] = lib, "; ".join(chip_smoke.ptxas_resources(log))
    return out


def with_lib(lib, fn):
    """fn with _build.lib() returning `lib` while it runs."""
    def run():
        saved, _build._lib = _build._lib, lib
        try:
            return fn()
        finally:
            _build._lib = saved
    return run


def frame_rays(ds, tex, bvh, cfg, dev) -> dict:
    """The shadow_pass capture of the fourth frame from a cold state."""
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev)
    cap = {}
    for _ in range(4):
        state = frame.render_frame(ds, state, params, sp, cfg, textures=tex, bvh=bvh, capture=cap)[2]
    torch.cuda.synchronize()
    return cap["trace"]


def origin_order(o) -> tuple[torch.Tensor, float]:
    """Morton order of the origins on a 2^10 grid over their bounding box,
    and the ms the glue takes to build it (CUDA events)."""
    def build():
        lo, hi = o.amin(dim=0), o.amax(dim=0)
        q = ((o - lo) / torch.clamp(hi - lo, min=1e-20) * 1023).clamp(0, 1023).long()
        code = torch.zeros_like(q[:, 0])
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        return torch.argsort(code).to(torch.int32)
    return build(), chip_smoke.cuda_ms(build, 5)


def steps_order(order, walked, long_steps: int | None = None) -> tuple[torch.Tensor, float]:
    """`order` re-sorted so the rays walking the most steps come first
    (stable, so the order holds within ties), by their step counts
    `walked` (this frame's: the previous frame's of a static view), or
    with long_steps, only the rays over long_steps moved to the front;
    and the ms the glue takes (CUDA events)."""
    def build():
        key = walked[order.long()]
        key = -key if long_steps is None else -(key > long_steps).to(key.dtype)
        return order[torch.sort(key, stable=True).indices]
    return build(), chip_smoke.cuda_ms(build, 5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0] + " " + __doc__.splitlines()[1])
    ap.add_argument("--baseline", required=True, help="another tree of the repository (its niagara_tpu_torch/)")
    ap.add_argument("--other", action="append", default=[], metavar="DIR",
                    help="a further tree whose trace_cuda (given the ray order) is timed as a variant")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi()
    base = chip_smoke.load_baseline(opts.baseline)
    others = {f"tree {path}": chip_smoke.load_baseline(path, f"other{i}_niagara_tpu_torch")
              for i, path in enumerate(opts.other)}
    for m in others.values():
        m[0].lib()
    others = {k: m[3] for k, m in others.items()}
    _build.lib()
    base[0].lib()
    libs = build_variants([(name, v) for name, values in CONSTANTS.items() for v in values])
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    for line in chip_smoke.ptxas_resources(_build.build_info["log"]):
        if "trace" in line:
            print(f"ptxas as built: {line}")
    for k, (_, ptx) in libs.items():
        print(f"ptxas {k}: {ptx}")
    for line in chip_smoke.ptxas_resources(base[0].build_info["log"]):
        if "trace" in line:
            print(f"ptxas baseline: {line}")

    g = cooker.cook_procedural()
    draws = cooker.synthesize_draws(g.meshes.count, draw_count=1_000_000)
    caps = presets.headline_capacities(draws.count)
    rays = {}
    ds = scene.from_numpy(scene.upload(g, draws), dev)
    bvh = shadow.build_scene_rt(g, draws)[0].to(dev)
    rays["trace"] = (bvh, frame_rays(ds, None, bvh, frame.FrameConfig(width=1920, height=1080, shadows=True, **caps),
                                     dev))
    del ds
    ga, da, mats, masks, mips = cooker.alpha_scene(g, draws)
    table = textures.build_texture_table(mips)
    ds = scene.from_numpy(scene.upload(ga, da, mats, masks, texture_table=table), dev)
    bvh = shadow.build_scene_rt(ga, da, mats, mips)[0].to(dev)
    cfg = frame.FrameConfig(width=1920, height=1080, post_passes=2, shadows=True, shadow_quality=1, **caps)
    rays["trace_alpha"] = (bvh, frame_rays(ds, textures.to_device(table, dev), bvh, cfg, dev))
    del ds

    rows = []
    for name, (bvh, tr) in rays.items():
        o, d, alpha, budget, order = (tr[k] for k in ("origin", "direction", "alpha_test", "max_steps", "order"))
        p_occ, p_steps = shadow.trace_plain(bvh, o, d, max_steps=budget, alpha_test=alpha)
        walked = p_steps.clamp(min=0) + (p_steps < 0).to(p_steps.dtype) * budget
        oo, glue_ms = origin_order(o)
        lpt, lpt_ms = steps_order(order, walked)
        lpt256, lpt256_ms = steps_order(order, walked, 256)
        short = dict(max_steps=256, alpha_test=alpha, order=order)
        s_occ, s_steps = shadow.trace_plain(bvh, o, d, max_steps=256, alpha_test=alpha)
        print(f"{name}: {chip_smoke.steps_line(p_steps, p_occ, budget, order)}; origin order SIMD efficiency "
              f"{chip_smoke.simd_efficiency(walked, oo):.4f}", flush=True)
        lo, ld = o[order.long()].contiguous(), d[order.long()].contiguous()
        back = torch.empty_like(order, dtype=torch.long)
        back[order.long()] = torch.arange(len(order), device=dev)
        old = lambda: base[3].trace_cuda(bvh, o, d, max_steps=budget, alpha_test=alpha)  # noqa: E731
        new = dict(max_steps=budget, alpha_test=alpha, order=order)
        for blocks in (1, 2):  # every warp refills many times
            occ, steps = shadow.trace_cuda(bvh, o, d, **new, blocks=blocks)
            chip_smoke.check(torch.equal(occ, p_occ) and torch.equal(steps, p_steps),
                             f"{name} on {blocks} block(s): differs from trace_plain")
        variants = [("baseline, ray order (permuted in the glue)", None,
                     lambda: base[3].trace_cuda(bvh, lo, ld, max_steps=budget, alpha_test=alpha), back, 0.0),
                    ("as built", None, lambda: shadow.trace_cuda(bvh, o, d, **new), None, 0.0),
                    ("order: id", None, lambda: shadow.trace_cuda(bvh, o, d, **dict(new, order=None)), None, 0.0),
                    ("order: origins (+ glue sort)", None, lambda: shadow.trace_cuda(bvh, o, d, **dict(new, order=oo)),
                     None, glue_ms),
                    ("order: most steps first (+ glue sort)", None,
                     lambda: shadow.trace_cuda(bvh, o, d, **dict(new, order=lpt)), None, lpt_ms),
                    ("order: over 256 steps first (+ glue sort)", None,
                     lambda: shadow.trace_cuda(bvh, o, d, **dict(new, order=lpt256)), None, lpt256_ms)]
        for blocks in (132 * 2, 132 * 4, 132 * 16, 132 * 32):
            variants.append((f"blocks {blocks}", None, lambda b=blocks: shadow.trace_cuda(bvh, o, d, **new, blocks=b),
                             None, 0.0))
        for k, (lib, _) in libs.items():
            variants.append((k, lib, lambda: shadow.trace_cuda(bvh, o, d, **new), None, 0.0))
        for label, other in others.items():
            variants.append((label, None, lambda m=other: m.trace_cuda(bvh, o, d, **new), None, 0.0))
        for label, keep in (("rays over 512 steps", walked > 512), ("rays up to 512 steps", walked <= 512)):
            ids = torch.nonzero(keep).flatten()
            rank = torch.full_like(walked, -1, dtype=torch.long)
            rank[ids] = torch.arange(len(ids), device=dev)
            sub_order = rank[order.long()][keep[order.long()]].to(torch.int32)
            so, sd = o[ids].contiguous(), d[ids].contiguous()
            sub = dict(max_steps=budget, alpha_test=alpha, order=sub_order)
            got = shadow.trace_cuda(bvh, so, sd, **sub)
            chip_smoke.check(torch.equal(got[0], p_occ[ids]) and torch.equal(got[1], p_steps[ids]),
                             f"{name} {label}: differs")
            fns = {"this tree": lambda: shadow.trace_cuda(bvh, so, sd, **sub),
                   **{k: (lambda m=m: m.trace_cuda(bvh, so, sd, **sub)) for k, m in others.items()}}
            for k, fn in fns.items():
                ms, base_ms = chip_smoke.in_turns(
                    fn, lambda: base[3].trace_cuda(bvh, so, sd, max_steps=budget, alpha_test=alpha), opts.reps)
                rows.append(dict(kernel=name, variant=f"subset: {label}, {k}", rays=len(ids), ms=ms,
                                 baseline_ms=base_ms, speedup=base_ms / ms, glue_ms=0.0, device=smi))
                print(f"{name:12s} {'subset: ' + label + ' (' + str(len(ids)) + '), ' + k:44s} {ms:8.4f} ms  baseline "
                      f"{base_ms:8.4f} ms  {base_ms / ms:5.2f}x", flush=True)
        occ, steps = shadow.trace_cuda(bvh, o, d, **short)
        chip_smoke.check(torch.equal(occ, s_occ) and torch.equal(steps, s_steps), f"{name} budget 256: differs")
        ms, base_ms = chip_smoke.in_turns(lambda: shadow.trace_cuda(bvh, o, d, **short), old, opts.reps)
        cut = s_steps.clamp(min=0) + (s_steps < 0).to(s_steps.dtype) * 256
        rows.append(dict(kernel=name, variant="diagnostic: budget 256", ms=ms, baseline_ms=base_ms,
                         speedup=base_ms / ms, glue_ms=0.0, device=smi, steps_mean=float(cut.float().mean())))
        label = f"diagnostic: budget 256 (steps mean {float(cut.float().mean()):.2f})"
        print(f"{name:12s} {label:44s} {ms:8.4f} ms  baseline {base_ms:8.4f} ms (budget 1024)", flush=True)
        for label, lib, fn, unpermute, extra_ms in variants:
            fn = with_lib(lib, fn) if lib else fn
            occ, steps = fn()
            if unpermute is not None:
                occ, steps = occ[unpermute], steps[unpermute]
            chip_smoke.check(torch.equal(occ, p_occ) and torch.equal(steps, p_steps),
                             f"{name} {label}: differs from trace_plain")
            ms, base_ms = chip_smoke.in_turns(fn, old, opts.reps)
            ms += extra_ms
            rows.append(dict(kernel=name, variant=label, ms=ms, baseline_ms=base_ms, speedup=base_ms / ms,
                             glue_ms=extra_ms, device=smi))
            print(f"{name:12s} {label:44s} {ms:8.4f} ms  baseline {base_ms:8.4f} ms  {base_ms / ms:5.2f}x", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trace_sweep.json"), "w") as f:
        json.dump(dict(device=smi, time=time.strftime("%Y-%m-%d %H:%M:%S"), rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
