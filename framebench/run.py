"""The port's frame benchmark: one cell, one run.

    python3 framebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration (framebench/configs/<config>.json, its kind
in framebench/kinds/<kind>.py) and traffic mix
(framebench/traffic/<traffic>.json, naming its camera path in
framebench/cameras/ and its motion in framebench/motions/), builds the
scene on the first card through niagara_tpu_torch (set-up), warms up, then
renders frames back to back for `--seconds` as the port's viewer does,
waiting for each frame's image before the next.  With `--trace 0` it
prints the cell's end-to-end metrics; with `--trace 1` the window carries
StageTimer boundaries, a few more frames run under torch.profiler, and
one more is captured for the work counts: it prints the cell's per-layer
metrics (framebench/metrics/<name>.py each).  After the window a frame
of it drawn from the seed is replayed with its intermediate outputs kept,
the program is freed, and the reference (framebench/ref, independent of
the program, or the configuration kind's own) renders the same frame from
the same inputs; `correct` says whether every compared number
(core/check.py, and the kind's own) is within the cell's limits
(framebench/limits/<cell>.json).

The last line of standard output is one JSON object; an earlier line holds
the device record.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".cache", "framebench")
FORBIDDEN = ("jax", "jaxlib", "flax", "niagara_tpu")
TRACE_FRAMES = 10
SAMPLE_RANGE = 48  # the checked frame of the window is drawn from its first 48


def log(msg: str) -> None:
    print(f"[framebench] {msg}", file=sys.stderr, flush=True)


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic mix, configuration entry)
    by the cell's name in BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"framebench: no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "framebench", "traffic", f"{cell['traffic']}.json")) as f:
        mix = json.load(f)
    return bench, cell, config, mix, entry


def cell_hooks(config: dict, mix: dict, root: str = ROOT):
    """(configuration kind, camera path, motion or None), found by name."""
    from core import hooks

    motion = hooks.load(root, "motions", mix["motion"]) if mix.get("motion") else None
    return hooks.load(root, "kinds", config["kind"]), hooks.load(root, "cameras", mix["camera"]), motion


def cell_limits(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "framebench", "limits", f"{name}.json")) as f:
        return json.load(f)


def extra_limit(limits: dict, name: str, cell: str) -> float:
    """The limit of a number that the configuration's kind adds; a number
    with no limit ends the run."""
    if name not in limits:
        raise SystemExit(f"framebench: the kind's number {name!r} has no limit in framebench/limits/{cell}.json")
    return limits[name]


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str, root: str = ROOT):
    from core import hooks

    return hooks.load(root, "metrics", name).read


def nvidia_smi() -> dict:
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,driver_version"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    rows = [r.split(", ") for r in out.stdout.strip().splitlines()] if out.returncode == 0 else []
    return {"gpus": [dict(zip(q.split(","), r)) for r in rows]}


def device_record(torch, chips: int) -> dict:
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips, torch=torch.__version__,
                cuda=torch.version.cuda, python=sys.version.split()[0], **nvidia_smi())


def wait(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class RunData:
    """What a per-layer reader sees."""

    def __init__(self, cell, config, mix, stages, trace, work):
        self.cell, self.config, self.mix = cell, config, mix
        self.stages, self.trace, self.work = stages, trace, work


def run(opts, dev=None, root: str = ROOT) -> tuple[dict, list]:
    """One run of a cell; `dev` given skips the look for a card (the CPU
    tests).  Returns (the result, the compared numbers)."""
    import numpy as np
    import torch

    from core import check as check_mod, hooks, reference, renderer, trace as trace_mod, work as work_mod
    from niagara_tpu_torch.utils.profiling import StageTimer

    bench, cell, config, mix, _ = load_cell(opts.workload, root)
    kind, camera, motion = cell_hooks(config, mix, root)
    limits = cell_limits(cell["name"], root)
    cuda = dev is None
    if cuda:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        record = device_record(torch, cell["chips"])
        print(json.dumps({"device_record": record}), flush=True)
    else:
        record = dict(platform=dev.type, kind=dev.type, count=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- set-up: inputs, scene, shadow source, warm-up
    cache_root = os.path.join(root, ".cache", "framebench")
    if cuda:
        from niagara_tpu_torch import _build

        _build.lib()
    x = kind.make_inputs(config, opts.seed)
    prog = renderer.Renderer(config, mix, x, kind.program_geometry(config, cache_root), dev, opts.seed, camera,
                             motion)
    setup_drops = int(prog.setup_drops)
    k_sample = int(np.random.default_rng([opts.seed % (1 << 63), 1]).integers(0, SAMPLE_RANGE))

    start_state = prog.init_state()
    start = prog.step(0, start_state)
    i = 1
    state = start["state"]
    for _ in range(mix["warmup_frames"]):
        state = prog.step(i, state)["state"]
        i += 1
    wait(torch, dev)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.2f} s; cell {cell['name']}, seed {opts.seed}, {prog.ds.num_draws} draws, "
        f"{prog.ds.num_meshlets} meshlets, checked frame {k_sample} of the window")

    # ---- the window
    stages = StageTimer(dev) if opts.trace else None
    frame_s, failed = [], torch.zeros((), dtype=torch.int64, device=dev)
    sample, enqueue_s, dropped = None, 0.0, None
    smi_before = nvidia_smi() if cuda else {}
    t0 = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        if stages is not None:
            stages.begin()
        out = prog.step(i, state, stages=stages)
        enqueue_s += time.perf_counter() - h0
        wait(torch, dev)
        h1 = time.perf_counter()
        frame_s.append(h1 - h0)
        failed += (out["drops"].sum() > 0).to(torch.int64)
        dropped = out["drops"] if dropped is None else dropped + out["drops"]
        last = (i, state, out)
        if len(frame_s) == k_sample + 1:
            sample = last
        state = out["state"]
        i += 1
        if h1 - t0 >= opts.seconds:
            break
    window_s = time.perf_counter() - t0
    if sample is None:
        sample = last
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    attempted, n_failed = len(frame_s), int(failed)
    q = [frame_s[k * attempted // 4:(k + 1) * attempted // 4] for k in range(4)]
    log(f"window: {attempted} frames in {window_s:.3f} s, {n_failed} failed (dropped over the window: commands, "
        f"clusters, triangles, pairs[, sun band] {dropped.tolist()}); mean ms by quarter "
        f"{[round(sum(x) / max(len(x), 1) * 1e3, 3) for x in q]}; host enqueue {enqueue_s / attempted * 1e3:.3f} ms "
        f"a frame, the rest waiting for the device; cards before/after {smi_before} / "
        f"{nvidia_smi() if cuda else {}}; on CPUs {sorted(os.sched_getaffinity(0))}")

    # ---- per-layer readings (the traced run)
    metrics, device = {}, dict(record, memory_peak_bytes=int(peak))
    for key in ("torch", "cuda", "python", "gpus"):
        device.pop(key, None)
    breakdown = None
    if opts.trace:
        tr = None
        if cuda:
            holder = {"state": state, "i": i}

            def one(_k):
                o = prog.step(holder["i"], holder["state"])
                wait(torch, dev)
                holder["state"], holder["i"] = o["state"], holder["i"] + 1

            tr = trace_mod.profile_frames(one, TRACE_FRAMES)
            state, i = holder["state"], holder["i"]
            device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
            breakdown = dict(device_ops=[[n[:160], s] for n, s in tr.device_ops()],
                             idle_gaps=[[n[:160], s] for n, s in tr.idle_gaps()])
        cap, sun_cap = {}, ({} if prog.tail is not None else None)
        prog.step(i, state, capture=cap, sun_capture=sun_cap)
        wk = work_mod.frame_work(cap, sun_cap, prog.cfg.width, prog.cfg.height,
                                 config["sun_map"]["size"] if sun_cap is not None else None)
        del cap, sun_cap
        data = RunData(cell, config, mix, stages.resolve(), tr, wk)
        for m in cell_metrics(bench, cell, True):
            v = reader(m["name"], root)(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(frame_ms=window_s / attempted * 1e3,
                      frame_ms_p95=float(np.percentile(np.array(frame_s) * 1e3, 95)),
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in cell_metrics(bench, cell, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # ---- correctness: the sampled frame replayed with its intermediate
    # outputs kept, the program freed, then the reference's frame
    k_i, k_state, k_out = sample
    cap = {}
    replay = prog.step(k_i, k_state, capture=cap)
    checks = {"replay": (check_mod.share_differing(replay["image"], k_out["image"]), 0.0)}
    pv = check_mod.program_view(replay, cap, float(config["camera"]["znear"]), prog.frame)
    program_extra = hooks.kind_hook(kind, "program_extra")
    p_extra = None if program_extra is None else program_extra(replay, cap, config)
    sun_frame = prog.sun_frame()
    prog.free()
    del state, out, last, sample, k_state, k_out, replay, cap, start, start_state
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rf = reference.render(config, mix, kind, x, k_i, opts.seed, dev, camera, motion)
    for k, v in check_mod.compare(pv, rf, check_mod.pixel_size(config)).items():
        checks[k] = (v, limits[k])
    if sun_frame is not None:
        band = reference.sun_band(config, mix, kind, x, k_i, opts.seed, dev, motion, sun_frame)
        checks["sunmap"] = (check_mod.compare_sun_band(pv["sun_map"][band[0]], band, sun_frame), limits["sunmap"])
    for k, v in check_mod.compare_extra(kind, p_extra, rf, check_mod.pixel_size(config)).items():
        checks[k] = (v, extra_limit(limits, k, cell["name"]))
    log(f"reference: {time.perf_counter() - t_ref:.2f} s; compared over {check_mod.COUNTS}")
    checks["setup_drops"] = (setup_drops, 0)
    correct = all(v <= lim for v, lim in checks.values())

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"the run loaded {found}: refused")
        raise SystemExit(3)
    result = dict(correct=correct, attempted=attempted, failed=n_failed, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 framebench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    _, cell, _, _, _ = load_cell(opts.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result, checks = run(opts)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
