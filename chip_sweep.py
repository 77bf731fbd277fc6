"""Time variants of the port's kernels on one GPU, each in turns with a
yardstick on the same inputs.  From the repository's root:

    python3 chip_sweep.py trace --baseline DIR [--other DIR ...] [--reps N]
    python3 chip_sweep.py bloom [--baseline DIR] [--rounds N (20)]

DIR holds another tree of the repository (e.g. an earlier commit unpacked
by `git archive` into the ignored .cache/).  A variant that changes a
kernel's source is a copy of its csrc/ file with one edit (TRACE_EDITS,
BLOOM_EDITS: a pattern that must match exactly once), built alone, one
nvcc each, all at once (`build_copies`).  Every variant is checked against
the plain version before it is timed (chip_smoke.in_turns: yardstick,
variant, variant, yardstick).  One line a variant; every row also goes to
chiprun_out/<kernel>_sweep.json.

`trace`: the BVH walk (csrc/trace.cu), against DIR's ops/shadow.py
trace_cuda.  The rays are those of the benchmark's ray-traced frames
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
    own time added), `blocks`, each schedule constant of trace.cu
    (TRACE_EDITS; ptxas's registers and spills printed), and the
    trace_cuda of each `--other` tree;
  - the rays over 512 steps and the rest, each set alone, and the whole
    set under a 256-step budget (against trace_plain under it);

each held to trace_plain flag for flag and step for step, `--reps`
launches a turn.

`bloom`: the down and up chain (csrc/bloom.cu) on a seeded 1920x1080 g0
with nonzero emissive (render/parity.py replay_bloom's), its
half-resolution emissive mip 0 and the 8-level chain from it.  The
yardstick is DIR's down2_cuda and up2_add_cuda a level a launch (without
DIR, this tree's).  Printed: each launch of the chain alone beside the
yardstick's kernel (and the tile edits' kernels); torch.profiler's kernel
times of a chain; the chain as built (ops/bloom.py cuda_chain), without
the tail (this tree's kernels a level a launch), with the tail from mip 3,
4 and 5, and as built from each of BLOOM_EDITS (chip_smoke.chain_times:
the device's ms of 20 chains behind a spin kernel, the ms of 100 chains
back to back, the host's enqueue ms; the tail alone beside the levels it
replaces); then the chain and the frame's bloom stage (compute_bloom and
sample_bloom_fullres on the g0) with and without the tail, `--rounds`
rounds in turns (METRICS of 20 calls a sample: device ms, host enqueue
ms), with the rounds in which the tail's side was lower.
Every chain is held bit for bit to the plain chain, every level a tail
writes to tail_plain's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke
from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import bloom, shadow
from niagara_tpu_torch.render import camera, frame, parity, presets, textures

ROOT = os.path.dirname(os.path.abspath(__file__))

# copies of a csrc/ file with one edit each: (label, pattern, replacement)
# trace.cu's schedule constants, the values tried beside the built ones
# (refill 8, batch 4, tail 8, minimum blocks 1)
TRACE_EDITS = tuple((f"{name} {v}", rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};")
                    for name, values in {"kRefill": (1, 4, 16, 32), "kBatch": (1, 2, 8), "kTail": (0, 1, 2, 4, 16),
                                         "kMinBlocks": (8, 12)}.items() for v in values)
BLOOM_EDITS = (("launches not dependent", re.escape("programmaticStreamSerializationAllowed = 1;"),
                "programmaticStreamSerializationAllowed = 0;"),
               ("bloom_down tile 32x16", re.escape("constexpr int kDownTx = 16, kDownTy = 4;"),
                "constexpr int kDownTx = 16, kDownTy = 8;"),
               ("bloom_up tile 32x8", re.escape("constexpr int kUpTx = 32, kUpTy = 4;"),
                "constexpr int kUpTx = 32, kUpTy = 8;"),
               ("tail 256 threads", re.escape("constexpr int kTailThreads = 512;"),
                "constexpr int kTailThreads = 256;"),
               ("tail 1024 threads", re.escape("constexpr int kTailThreads = 512;"),
                "constexpr int kTailThreads = 1024;"))
BLOOM_ENTRIES = ("bloom_down_launch", "bloom_up_launch", "bloom_tail_launch", "bloom_x2_launch")
BLOOM_STARTS = (3, 4, 5)


def edited_source(source: str, pattern: str, replacement: str) -> str:
    """csrc/<source>'s text with the one match of `pattern` replaced;
    raises unless it matches exactly once."""
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        text, count = re.subn(pattern, replacement, f.read())
    if count != 1:
        raise RuntimeError(f"{source} matches {pattern!r} {count} times, not once")
    return text


def build_copies(source: str, edits, entries) -> dict:
    """A copy of csrc/<source> for each (label, pattern, replacement) of
    `edits` (edited_source), built alone into the build directory, one nvcc
    each, all at once: {label: (the library with `entries` bound, ptxas's
    lines)}."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (label, pattern, replacement) in enumerate(edits):
        stem = os.path.join(_build.BUILD_DIR, f"{source.split('.')[0]}_variant{i}")
        with open(stem + ".cu", "w") as f:
            f.write(edited_source(source, pattern, replacement))
        procs[label] = stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for label, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        for name in entries:
            getattr(lib, name).argtypes = _build._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
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


def write_rows(kernel: str, smi: str, rows: list) -> None:
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{kernel}_sweep.json"), "w") as f:
        json.dump(dict(device=smi, time=time.strftime("%Y-%m-%d %H:%M:%S"), rows=rows), f, indent=1)


# ---------------------------------------------------------------- trace


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


def trace(opts) -> None:
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
    libs = build_copies("trace.cu", TRACE_EDITS, ("trace_launch",))
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
    write_rows("trace", smi, rows)



# ---------------------------------------------------------------- bloom


def kernel_times(fn, n: int = 5) -> list:
    """torch.profiler over n chains: each bloom.cu launch's mean device
    duration in µs, in launch order (its own time, not the gaps between
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and "bloom_" in e.name),
                key=lambda e: e.time_range.start)
    per = len(ev) // n
    chip_smoke.check(per > 0 and len(ev) == per * n, f"the profiler saw {len(ev)} bloom.cu launches in {n} chains")
    names = [ev[i].name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0] for i in range(per)]
    mean = [sum(ev[i + k * per].time_range.elapsed_us() for k in range(n)) / n for i in range(per)]
    return list(zip(names, mean))


METRICS = {"ms": chip_smoke.cuda_ms, "host_ms": chip_smoke.host_ms}


def rounds_in_turns(a, b, rounds: int) -> tuple[dict, dict]:
    """Each of METRICS (device ms of 20 calls behind the spin kernel, host
    enqueue ms of 20 calls) of a and b, `rounds` rounds in turns (a, b, b,
    a): two samples of each a round, as {metric: [...]}."""
    out = {id(a): {k: [] for k in METRICS}, id(b): {k: [] for k in METRICS}}
    for _ in range(rounds):
        for fn in (a, b, b, a):
            for k, measure in METRICS.items():
                out[id(fn)][k].append(measure(fn, 20))
    return out[id(a)], out[id(b)]


def spread(xs: list) -> str:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"median {q2:.4f} (quartiles {q1:.4f}-{q3:.4f}, range {min(xs):.4f}-{max(xs):.4f})"


def lower_rounds(a: list, b: list) -> int:
    """The rounds (two samples of each side, in turns) in which a's mean
    is below b's."""
    return sum(a[i] + a[i + 1] < b[i] + b[i + 1] for i in range(0, len(a), 2))


def bloom_sweep(opts) -> None:
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi()
    base = chip_smoke.load_baseline(opts.baseline)[4] if opts.baseline else None
    _build.lib()
    if base is not None:
        base._build.lib()
    libs = build_copies("bloom.cu", BLOOM_EDITS, BLOOM_ENTRIES)
    print(f"{torch.cuda.get_device_name(0)} | {smi}", flush=True)
    for line in chip_smoke.ptxas_resources(_build.build_info["log"]):
        if "bloom" in line:
            print(f"ptxas: {line}", flush=True)

    width, height = 1920, 1080
    g0 = torch.rand((height, width, 4), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    rep = parity.replay_bloom(g0, width, height)
    g0, mips, levels, half, full = rep["g0"], rep["mips"], rep["levels"], rep["half"], rep["full"]
    yard_mod = base if base is not None else bloom
    yardstick = lambda: chip_smoke.level_chain(yard_mod, mips[0], levels)  # noqa: E731
    yard_name = "the baseline's" if base is not None else "this tree's"

    for c in rep["calls"]:  # each launch alone, in turns with the yardstick's kernel on the same input
        if c["name"] not in ("bloom_down", "bloom_up"):
            continue
        old = (lambda s=c["src"]: yard_mod.down2_cuda(s)) if c["name"] == "bloom_down" else \
            (lambda s=c["src"], m=c.get("mip"): yard_mod.up2_add_cuda(s, m))
        ms, old_ms = chip_smoke.in_turns(c["kernel"], old, 20)
        line = f"{c['name']} on {tuple(c['src'].shape)}: {ms:.4f} ms, {yard_name} {old_ms:.4f} ms"
        for label, (lib, _) in libs.items():
            if c["name"][6:] in label:  # the tile edits of this kernel
                same = with_lib(lib, c["kernel"])
                chip_smoke.check(torch.equal(same().view(torch.int32), c["out"].view(torch.int32)), f"{label} differs")
                line += f", {label} {chip_smoke.cuda_ms(same, 20):.4f} ms"
        print(line, flush=True)

    for label, fn in (("as built", lambda: bloom.cuda_chain(mips[0], levels)),
                      (f"{yard_name} a level a launch", yardstick)):
        kernels = kernel_times(fn)
        print(f"profiler, {label}: kernels {sum(t for _, t in kernels):.1f} µs: "
              + ", ".join(f"{name} {t:.1f}" for name, t in kernels), flush=True)

    def split_at(start):
        return lambda: bloom.split_chain(mips[0], levels, start, bloom.down2_cuda, bloom.up2_add_cuda,
                                         bloom.tail_cuda)

    variants = [(f"as built (tail from mip {rep['start']})", None, lambda: bloom.cuda_chain(mips[0], levels),
                 rep["start"]),
                ("no tail (this tree's kernels a level a launch)", None,
                 lambda: chip_smoke.level_chain(bloom, mips[0], levels), None)]
    variants += [(f"tail from mip {s}", None, split_at(s), s) for s in BLOOM_STARTS if s != rep["start"]]
    variants += [(f"as built, {label}", lib, lambda: bloom.cuda_chain(mips[0], levels), rep["start"])
                 for label, (lib, _) in libs.items()]
    rows = []
    for label, lib, fn, start in variants:
        fn = with_lib(lib, fn) if lib else fn
        chip_smoke.check(torch.equal(fn().view(torch.int32), half.view(torch.int32)),
                         f"{label}: the chain differs from the plain chain")
        row = dict(variant=label, start=start, device=smi, **chip_smoke.chain_times(fn, yardstick))
        line = (f"{label:46s} chain {row['ms']:.4f} ms (100: {row['ms_100']:.4f}, host {row['host_ms']:.4f}) | "
                f"{yard_name} a level a launch {row['old_ms']:.4f} ms (100: {row['old_ms_100']:.4f}, host "
                f"{row['old_host_ms']:.4f})")
        if start is not None:
            n = levels - start
            tail = lambda s=start: bloom.tail_cuda(mips[s], n)  # noqa: E731
            tail = with_lib(lib, tail) if lib else tail
            for k_out, p_out in zip(tail(), bloom.tail_plain(mips[start], n)):
                chip_smoke.check(torch.equal(k_out.view(torch.int32), p_out.view(torch.int32)),
                                 f"{label}: a level of the tail differs from tail_plain's")
            replaced = lambda s=start: chip_smoke.level_chain(yard_mod, mips[s], n)  # noqa: E731
            row["tail_ms"], row["replaced_ms"] = chip_smoke.in_turns(tail, replaced, 20)
            line += f" | tail {row['tail_ms']:.4f} ms vs its {2 * (n - 1)} levels a launch {row['replaced_ms']:.4f} ms"
        rows.append(row)
        print(line, flush=True)

    # the tail's effect: the chain and the frame's bloom stage (what
    # render/frame.py composite_frame calls) with and without it
    chain, no_tail_chain = variants[0][2], variants[1][2]
    stage = lambda: bloom.sample_bloom_fullres(bloom.compute_bloom(g0, width, height), width, height)  # noqa: E731
    no_tail_stage = lambda: bloom.sample_bloom_fullres(  # noqa: E731
        chip_smoke.level_chain(bloom, bloom.extract_emissive(g0, width, height), levels), width, height)
    for fn in (stage, no_tail_stage):
        chip_smoke.check(torch.equal(fn().view(torch.int32), full.view(torch.int32)),
                         "a bloom stage differs from the plain expansion")
    for what, a, b in (("chain", chain, no_tail_chain), ("bloom stage", stage, no_tail_stage)):
        with_tail, without = rounds_in_turns(a, b, opts.rounds)
        for label, r in (("as built", with_tail), ("no tail", without)):
            rows.append(dict(variant=f"{what}, {label}, {opts.rounds} rounds in turns", device=smi, **r))
            print(f"{what:11s} {label:8s} ({opts.rounds} rounds in turns, 20 calls a sample): "
                  + "; ".join(f"{k} {spread(r[k])}" for k in METRICS), flush=True)
        print(f"{what:11s} as built lower in " + ", ".join(
            f"{k} {lower_rounds(with_tail[k], without[k])}" for k in METRICS) + f" of {opts.rounds} rounds", flush=True)
    write_rows("bloom", smi, rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0] + " " + __doc__.splitlines()[1])
    sub = ap.add_subparsers(dest="kernel", required=True)
    t = sub.add_parser("trace", help="the BVH walk (csrc/trace.cu)")
    t.add_argument("--baseline", required=True, help="another tree of the repository (its niagara_tpu_torch/)")
    t.add_argument("--other", action="append", default=[], metavar="DIR",
                   help="a further tree whose trace_cuda (given the ray order) is timed as a variant")
    t.add_argument("--reps", type=int, default=20)
    b = sub.add_parser("bloom", help="the bloom chain (csrc/bloom.cu)")
    b.add_argument("--baseline", help="another tree of the repository (its niagara_tpu_torch/)")
    b.add_argument("--rounds", type=int, default=20, help="rounds in turns of the tail's effect")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device", file=sys.stderr)
        return 2
    (trace if opts.kernel == "trace" else bloom_sweep)(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
