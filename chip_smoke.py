#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (niagara_tpu_torch) on one GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.

Phases, each reported on its own line:
  device        -- needs CUDA (exits nonzero without it); prints the card's
                   name and power limit as nvidia-smi reports them;
  build         -- nvcc builds csrc/*.cu (one process per source, all at
                   once) while g++ builds the port's C++ cooker;
  scene         -- the procedural mesh, 1,000,000 draws (the reference's
                   PCG scatter), uploaded to the card;
  small         -- a 256x128 frame of 48 draws through the kernels on the
                   card against the plain torch path on the CPU (the path
                   the CPU tests hold to the JAX reference);
  warmup/main   -- the opaque headline path: two 1920x1080 frames from a
                   cold state (the second one's kernel inputs are kept),
                   then, with the launch counters at zero, three chained
                   frames through render_frame (frames 2-4, the steady
                   state): loss-free, finite, every kernel launched as often
                   as the frame calls it; the last frame's inputs are kept;
  kernels       -- setup, raster and shade replayed on the kept inputs of
                   the transitional frame 1 and the steady frame 4, each
                   against its plain torch version on the same inputs
                   (exact: both round every op as IEEE f32, the kernels are
                   built with --fmad=false), both timed with CUDA events;
  alpha small   -- the textured, alpha-classed small scene
                   (cooker.small_alpha_scene), two frames, kernels on the
                   card against the plain path on the CPU; its masks must
                   discard pixels;
  alpha scene   -- the benchmark's textured frame: the same 1M draws with
                   planar uvs, 8 checker-textured materials (1/8 of the
                   draws in the alpha class), opacity masks, texture table;
  alpha warmup/alpha main -- that frame (post_passes=2) as the opaque path:
                   two cold frames, then three steady frames with the
                   counters at zero, each loss-free, the setup kernel's
                   alpha variant in both passes, the raster kernel's
                   alpha_test variant in the merged late pass;
  alpha kernels -- the alpha variants (and the opaque raster of the early
                   pass) replayed on a transitional and a steady alpha frame
                   against their plain versions, exact, with a tie merge
                   and (alpha_test) with random mask bits; the pixels the
                   masks change (against the opaque variant on the same
                   inputs): the path's own masks may change none, the
                   random ones must;
  profile       -- torch.profiler over five more frames of each path:
                   device ops and kernel launches per frame, device busy
                   time and idle share, the costliest device ops.
The line before the last is the per-kernel JSON record (times, launches and
bounds of the steady frames); the last line is {"ok": true, "device": ...}.
Any failed check raises (nonzero exit).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DROPS = ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped")
INVALID = 0x7FFFFFFF
# NVIDIA H100 SXM peaks (data sheet; at a 700 W power limit): HBM bytes/s,
# f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# f32 operations per unit of work, counted from the kernel sources: setup.cu
# eval_slot per live triangle slot (three corner transforms and snaps,
# edges, depth plane, bounds); raster.cu per (record, pixel) test (three
# edges, the depth plane, the fill rule and the depth/id compare) and per
# covered pixel of a masked record (uv interpolation, cell, bit); shade.cu
# per covered pixel (weights, six interpolated channels, uv/pixel areas)
SETUP_OPS, RASTER_OPS, MASK_OPS, SHADE_OPS = 420, 28, 34, 70
REC_BYTES = 56 * 4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors or dicts of tensors; raises if any
    element differs in an integer tensor or in its non-finite pattern."""
    import torch

    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if not a.is_floating_point():
        check(torch.equal(a, b), "integer outputs differ")
        return 0.0
    check(torch.equal(torch.isfinite(a), torch.isfinite(b)), "non-finite pattern differs")
    return float((a - b).abs().max()) if a.numel() else 0.0


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of bytes over
    the HBM rate and operations over the f32 rate, and which one it is."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def frame_line(s: dict) -> str:
    return (f"visible_draws {int(s['visible_draws'])} early/late draws {int(s['early_commands'])}/"
            f"{int(s['late_commands'])} clusters {int(s['early_clusters'])}/{int(s['late_clusters'])} "
            f"candidates {int(s['candidates'])} tris {int(s['tri_count'])} pairs {int(s['pair_count'])} "
            f"drops {[int(s[k]) for k in DROPS]} pair_demand {s['pair_demand_vec'].tolist()} "
            f"pair_drops {s['pair_drop_vec'].tolist()}")


def pass_line(capture: dict) -> str:
    """Clusters, triangles and pairs per pass of a captured frame, and the
    alpha class's share of each."""
    parts = []
    for name, (tc, _), (ts, pt, rec, *_), stream in zip(("early", "late"), capture["setup"], capture["raster"],
                                                      capture["shade"][0]):
        k, n, p = int(tc["count"][0]), int(stream["count"]), int(ts[-1])
        post = rec[:n, 45] > 0
        parts.append(f"{name}: {k} clusters ({int((tc['post_pass'][:k] > 0).sum())} alpha), {n} tris "
                     f"({int(post.sum())} alpha), {p} pairs ({int((rec[pt[:p].long(), 45] > 0).sum())} alpha)")
    return "; ".join(parts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false -- this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from niagara_tpu_torch import _build, cooker, scene
    from niagara_tpu_torch.cooker import bindings
    from niagara_tpu_torch.ops import raster_tile, setup
    from niagara_tpu_torch.render import camera, frame, presets, textures

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.lib), pool.submit(bindings.get_lib)]
        for j in jobs:
            j.result()
    log("build", f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_info['seconds']}) -> "
        f"{_build.build_info['path']}, cooker {bindings.lib_path()}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower() or "Compiling entry" in line:
            log("build", line.strip())

    t0 = time.perf_counter()
    geometry = cooker.cook_procedural()
    draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=1_000_000)
    ds = scene.from_numpy(scene.upload(geometry, draws), dev)
    torch.cuda.synchronize()
    log("scene", f"{ds.num_draws} draws, {ds.num_meshlets} meshlets, lod0 triangles "
        f"{int(geometry.meshes.lod_index_count[0, 0]) // 3}, {time.perf_counter() - t0:.1f} s")

    small_reference("small", dev, scene.upload(geometry, cooker.small_scene_draws(geometry.meshes.count)), None,
                    frame.FrameConfig(width=256, height=128, **presets.small_capacities()), scene, camera, frame)

    cfg = frame.FrameConfig(width=1920, height=1080, **presets.headline_capacities(ds.num_draws))
    expected = {"setup": 6, "setup_alpha": 0, "raster": 6, "raster_alpha": 0, "shade": 3}
    opaque = run_path("", ds, None, cfg, dev, frame, camera, _build, expected, smi)
    compare_kernels("", "transitional frame 1", opaque["transitional"], ds, opaque["params"], cfg, setup, raster_tile)
    rows = compare_kernels("", "steady frame 4", opaque["steady"], ds, opaque["params"], cfg, setup, raster_tile)
    kernels = {r["name"]: dict(r, path="opaque", launches=opaque["launches"][r["name"]]) for r in rows}
    profile_frames("profile", ds, None, opaque["state"], opaque["params"], opaque["sp"], cfg, frame)
    del ds, opaque
    torch.cuda.empty_cache()

    # the textured, alpha-classed frame
    ga, da, mats, masks, mips = cooker.small_alpha_scene(geometry)
    small_table = textures.build_texture_table(mips)
    small_reference("alpha small", dev, scene.upload(ga, da, mats, masks, texture_table=small_table), small_table,
                    frame.FrameConfig(width=256, height=128, post_passes=2, **presets.small_capacities()),
                    scene, camera, frame)

    t0 = time.perf_counter()
    ga, da, mats, masks, mips = cooker.alpha_scene(geometry, draws)
    table = textures.build_texture_table(mips)
    ds = scene.from_numpy(scene.upload(ga, da, mats, masks, texture_table=table), dev)
    tex = textures.to_device(table, dev)
    torch.cuda.synchronize()
    log("alpha scene", f"{ds.num_draws} draws, {int((da.post_pass > 0).sum())} in the alpha class, "
        f"{len(mips)} materials with {mips[0][0].shape[0]}^2 textures, texel pool {table.texels.shape[0]}, "
        f"masks {masks.shape}, {time.perf_counter() - t0:.1f} s")
    cfg = frame.FrameConfig(width=1920, height=1080, post_passes=2, **presets.headline_capacities(ds.num_draws))
    expected = {"setup": 0, "setup_alpha": 6, "raster": 3, "raster_alpha": 3, "shade": 3}
    alpha = run_path("alpha ", ds, tex, cfg, dev, frame, camera, _build, expected, smi)
    compare_kernels("alpha ", "transitional frame 1", alpha["transitional"], ds, alpha["params"], cfg, setup,
                    raster_tile)
    rows = compare_kernels("alpha ", "steady frame 4", alpha["steady"], ds, alpha["params"], cfg, setup, raster_tile)
    for r in rows:
        if r["name"] in ("setup_alpha", "raster_alpha"):
            kernels[r["name"]] = dict(r, path="alpha", launches=alpha["launches"][r["name"]])
    profile_frames("alpha profile", ds, tex, alpha["state"], alpha["params"], alpha["sp"], cfg, frame)

    order = ("setup", "setup_alpha", "raster", "raster_alpha", "shade")
    check(set(kernels) == set(order), f"kernel rows {sorted(kernels)}")
    print(smi)
    print(json.dumps({"kernels": [kernels[n] for n in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def run_path(tag, ds, tex, cfg, dev, frame, camera, _build, expected, smi) -> dict:
    """Two cold frames, then three steady ones with the launch counters at
    zero: each loss-free and finite, the counters as `expected`.  Returns
    the inputs kept from frames 1 and 4, the launches, the state after
    frame 4 and the frame inputs."""
    import torch

    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    # from a cold state frame 0's early pass has nothing (no draw was visible
    # before) and its late pass takes the whole unoccluded set -- the camera-
    # cut case the late budgets are not sized for (reference frame.py:85-89:
    # drops for a frame, then heals); frame 1's early pass re-renders it
    state = frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev)
    transitional = {}
    for i in range(2):
        _, _, state, stats = frame.render_frame(ds, state, params, sp, cfg, textures=tex, capture=transitional)
        log(f"{tag}warmup", f"frame {i}: {frame_line(stats.to_dict())}")
    torch.cuda.synchronize()

    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    frame_ms, steady = [], {}
    for i in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        image, fb, state, stats = frame.render_frame(ds, state, params, sp, cfg, textures=tex,
                                                     capture=steady if i == 2 else None)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        s = stats.to_dict()
        covered = int((fb.vis != INVALID).sum())
        log(f"{tag}main", f"frame {i + 2}: {frame_ms[-1]:.3f} ms | {frame_line(s)} covered_px {covered}")
        check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), f"frame {i + 2} dropped work")
        check(tuple(image.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(image).all()),
              "image not finite")
        check(covered > 0 and int(s["visible_draws"]) < ds.num_draws, "nothing or everything visible")
    launches = dict(_build.LAUNCHES)
    log(f"{tag}main", f"launches {launches} (expected {expected}); frame ms {frame_ms} on {smi}")
    log(f"{tag}main", f"frame 4 per pass: {pass_line(steady)}")
    check(launches == expected, "kernel launch counts")
    return dict(transitional=transitional, steady=steady, launches=launches, state=state, params=params, sp=sp)


def small_reference(tag, dev, np_scene, table, cfg, scene, camera, frame) -> None:
    """256x128, two frames: kernels on the card vs the plain path on the
    CPU.  With a texture table (the alpha scene) the masks must discard:
    with them cleared the same frame covers other pixels."""
    import dataclasses

    import torch

    from niagara_tpu_torch.render import textures

    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    runs = {}
    for where in ("cpu", dev):
        sc = scene.from_numpy(np_scene, where)
        tex = None if table is None else textures.to_device(table, where)
        st = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, where)
        for _ in range(2):
            state_in = st
            img, fb, st, stats = frame.render_frame(sc, st, params, sp, cfg, textures=tex)
        runs[str(where)] = (img.cpu(), fb.depth.cpu(), fb.vis.cpu(), stats.to_dict(), frame.state_to_numpy(st))
    (ci, cd, cv, cs, cst), (gi, gd, gv, gs, gst) = runs["cpu"], runs[str(dev)]
    check(all(np.array_equal(cs[k], gs[k]) for k in cs), "frame stats differ from the CPU plain path")
    check(all(np.array_equal(a, b) for a, b in zip(cst, gst)), "frame state differs from the CPU plain path")
    check(torch.equal(cv, gv), "vis differs from the CPU plain path")
    depth_err = float((cd - gd).abs().max())
    image_err = float((ci - gi).abs().max())
    extra = ""
    if table is not None:
        nomask = dataclasses.replace(sc, meshlet_alpha=torch.zeros_like(sc.meshlet_alpha))
        _, nfb, _, _ = frame.render_frame(nomask, state_in, params, sp, cfg, textures=tex)
        discarded = int(((nfb.vis != INVALID) & (nfb.vis != fb.vis)).sum())
        extra = f", masks discard {discarded} px (they win them with the masks cleared)"
        check(discarded > 0, "the opacity masks discard nothing")
    # depth: every op rounded alike on both sides; image: the composite's
    # pow/exp (and the textures' sRGB decode) differ between the CPU's and
    # the GPU's math libraries (opaque: worst seen 9.24e-7 on an H100)
    log(tag, f"256x128 two frames, kernels on {dev} vs plain on cpu: stats/state/vis equal, "
        f"depth max_abs_err {depth_err:.3g}, image max_abs_err {image_err:.3g} (tolerances 0 / 2e-6), "
        f"covered px {int((cv != INVALID).sum())}{extra}")
    check(depth_err == 0.0 and image_err <= 2e-6, "small frame differs from the CPU plain path")


def setup_work(tc, out, alpha: bool) -> tuple[float, float]:
    """(bytes, operations) one setup call needs: per live cluster its tc
    row, per distinct meshlet its triangle, vertex and id rows (and mask
    rows of post-class meshlets in the alpha variant), per written triangle
    its record, box and flat index; SETUP_OPS per live triangle slot."""
    import torch

    k = int(tc["count"][0])
    mi, post = tc["mi"][:k], tc["post_pass"][:k]
    nbytes = k * (4 * 6 + 32) + int(torch.unique(mi).numel()) * (96 * 3 * 4 + 64 * 8 * 4 + 64 * 4)
    if alpha:
        nbytes += int(torch.unique(mi[post > 0]).numel()) * 8 * 96 * 4
    nbytes += int(out["count"]) * (REC_BYTES + 4 * 4 + 4)
    return nbytes, SETUP_OPS * float(tc["tri_count"][:k].sum())


def raster_work(args, alpha: bool, H: int, W: int, tiles_x: int) -> tuple[float, float]:
    """(bytes, operations) one raster call needs: tile starts, pair list,
    the staged columns of each record it references (13, 27 with masks),
    the carried and written depth/vis; RASTER_OPS per (pair, pixel) for
    the pixels of the pair's tile whose centres lie in the triangle's box
    (no other pixel can be covered; the kernel tests all 1,024) and, with
    masks, MASK_OPS per covered pixel of a masked record (its screen area
    from the record's corners, at most its clamped box)."""
    import torch

    ts, pt, rec = args[:3]
    p = int(ts[-1])
    ids = torch.unique(pt[:p].long())
    nbytes = ts.numel() * 4 + p * 4 + ids.numel() * (27 if alpha else 13) * 4 + H * W * 16
    # the box: x0/x1 in cols 12/14, y1 in col 15; col 13 holds the id, so y0
    # is setup's floor of the corners' smallest y (cols 17/25/33), 0 when a
    # corner is behind the eye (w, cols 18/26/34)
    r = rec[:, [12, 14, 15, 17, 25, 33, 18, 26, 34]][pt[:p].long()].double()
    behind = r[:, 6:9].min(dim=1).values <= 1e-9
    y0 = torch.where(behind, 0.0, torch.clamp(torch.floor(r[:, 3:6].min(dim=1).values), 0, H - 1))
    tile = torch.searchsorted(ts[1:].long(), torch.arange(p, device=ts.device), right=True)
    tx, ty = (tile % tiles_x) * 128, (tile // tiles_x) * 8
    nx = torch.clamp(torch.minimum(r[:, 1], tx + 128) - torch.maximum(r[:, 0], tx), min=0)
    ny = torch.clamp(torch.minimum(r[:, 2], ty + 8) - torch.maximum(y0, ty), min=0)
    ops = RASTER_OPS * float((nx * ny).sum())
    if alpha:
        r = rec[ids]
        r = r[r[:, 54] > 0].double()
        area = 0.5 * ((r[:, 24] - r[:, 16]) * (r[:, 33] - r[:, 17]) - (r[:, 25] - r[:, 17]) * (r[:, 32] - r[:, 16]))
        # a triangle crossing the camera plane has far-off corners: its
        # clamped screen box bounds what it covers (x0/x1 in cols 12/14;
        # col 13 holds the id, so y from the corners, clamped)
        sy = torch.clamp(r[:, [17, 25, 33]], 0, H)
        box = (r[:, 14] - r[:, 12]) * (sy.max(dim=1).values - sy.min(dim=1).values)
        ops += MASK_OPS * float(torch.minimum(area.abs(), box).sum())
    return nbytes, ops


def shade_work(streams, vis) -> tuple[float, float]:
    """(bytes, operations) of the attribute resolve: the visibility buffer,
    each winning record once (39 used floats), the attribute planes out;
    SHADE_OPS per covered pixel."""
    import torch

    covered = vis[vis != INVALID]
    winners = int(torch.unique(covered).numel())
    return vis.numel() * 4 + winners * 39 * 4 + vis.numel() * 13 * 4, SHADE_OPS * float(covered.numel())


def compare_kernels(tag, label, capture, ds, params, cfg, setup, raster_tile) -> list[dict]:
    """Each kernel (and variant) of one captured frame vs its plain version
    on the same inputs; times and bounds are per frame (all passes)."""
    import torch

    W, H, tiles_x = cfg.width, cfg.height, cfg.width // 128
    rows = {}

    def add(name, err, ms, pms, work):
        r = rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0))
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["bytes"] += work[0]
        r["ops"] += work[1]

    for pass_, (tc, cap) in zip(("early", "late"), capture["setup"]):
        name = "setup_alpha" if "alpha" in tc else "setup"
        k_out = setup.setup_cuda(tc, ds, params, W, H, cap)
        p_out = setup.setup_plain(tc, ds, params, W, H, cap)
        err = max_abs_err(k_out, p_out)
        log(f"{tag}kernels", f"{label} {name} {pass_}: {int(tc['count'][0])} clusters -> {int(k_out['count'])} "
            f"triangles ({int(k_out['dropped'])} over capacity), max_abs_err {err} (tolerance 0)")
        add(name, err, cuda_ms(lambda: setup.setup_cuda(tc, ds, params, W, H, cap), 10),
            cuda_ms(lambda: setup.setup_plain(tc, ds, params, W, H, cap), 3), setup_work(tc, k_out, "alpha" in tc))

    # the frame's two passes, then a tie merge: the pass's records onto its
    # own result re-rastered at a higher id offset -- every pixel they cover
    # ties and the merge must hand it to the smaller id, giving the result.
    # The alpha_test variant also takes the pass's records with seeded
    # random mask bits: the path's visible alpha draws pick coarse LODs
    # whose conservative masks may have no clear cell, which would leave
    # the discard branch untested at this size
    for pass_, args, alpha in zip(("early", "late"), capture["raster"], capture["raster_alpha_test"]):
        name = "raster_alpha" if alpha else "raster"
        args = (*args, tiles_x)
        ts, pt, rec, off, d0, v0, _ = args
        shifted = raster_tile.raster_cuda(ts, pt, rec, off + cfg.tri_capacity + cfg.late_tri_cap, d0, v0, tiles_x,
                                          alpha_test=alpha)
        cases = [("", args), (" tie merge", (ts, pt, rec, off, *shifted, tiles_x))]
        if alpha:
            gen = torch.Generator(device=rec.device).manual_seed(0)
            bits = torch.randint(0, 1 << 16, (rec.shape[0], 4), generator=gen, device=rec.device).float()
            noisy = rec.clone()
            noisy[:, 48:52] = torch.where((rec[:, 54] > 0)[:, None], bits, rec[:, 48:52])
            cases.append((" random masks", (ts, pt, noisy, *args[3:])))
            r = rec[torch.unique(pt[:int(ts[-1])].long())]
            r = r[r[:, 54] > 0]
            log(f"{tag}kernels", f"{label} {name} {pass_}: {int((r[:, 48:52] != 65535).any(dim=1).sum())} of "
                f"{r.shape[0]} masked records have a clear mask cell")
        err, results, discard = 0.0, [], ""
        for case, a in cases:
            kd, kv = raster_tile.raster_cuda(*a, alpha_test=alpha)
            pd, pv = raster_tile.raster_plain(*a, alpha_test=alpha)
            check(torch.equal(kv, pv), f"{label} {name} {pass_}{case}: vis differs")
            err = max(err, max_abs_err(kd, pd))
            results.append(kv)
            if alpha and case != " tie merge":
                # what the masks do: the same inputs without the mask test
                changed = int((raster_tile.raster_cuda(*a, alpha_test=False)[1] != kv).sum())
                what = "random masks" if case else "the path's masks"
                discard += f", {what} change {changed} px vs the test off"
                check(case == "" or changed > 0, "random masks discard nothing")
        check(torch.equal(results[0], results[1]), f"{label} {name} {pass_}: the tie merge must give the pass's result")
        log(f"{tag}kernels", f"{label} {name} {pass_}: {int(ts[-1])} pairs, vis equal (tie merge"
            f"{', random masks' if alpha else ''} too), depth max_abs_err {err} (tolerance 0){discard}")
        check(err == 0.0, f"{name} depth differs")
        add(name, err, cuda_ms(lambda: raster_tile.raster_cuda(*args, alpha_test=alpha), 10),
            cuda_ms(lambda: raster_tile.raster_plain(*args, alpha_test=alpha), 2), raster_work(args, alpha, H, W, tiles_x))

    streams, vis = capture["shade"]
    ka = raster_tile.shade_cuda(streams, vis)
    err = max_abs_err(ka, raster_tile.shade_plain(streams, vis))
    log(f"{tag}kernels", f"{label} shade: 2 streams, {int((vis != INVALID).sum())} covered px, max_abs_err {err}")
    add("shade", err, cuda_ms(lambda: raster_tile.shade_cuda(streams, vis), 20),
        cuda_ms(lambda: raster_tile.shade_plain(streams, vis), 5), shade_work(streams, vis))

    sources = dict(setup=("setup.cu", "niagara_tpu/ops/setup_fused.py:190"),
                   setup_alpha=("setup.cu", "niagara_tpu/ops/setup_fused.py:166"),
                   raster=("raster.cu", "niagara_tpu/ops/raster_tile.py:280"),
                   raster_alpha=("raster.cu", "niagara_tpu/ops/raster_tile.py:280"),
                   shade=("shade.cu", "niagara_tpu/ops/raster_tile.py:662"))
    out = []
    for name, r in rows.items():
        check(r["err"] == 0.0, f"{name} output differs from its plain version")
        bms, by = bound(r["bytes"], r["ops"])
        log(f"{tag}kernels", f"{label} {name}: kernel {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms per frame, "
            f"bound {bms:.4f} ms by {by} ({r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.2f} Gop), "
            f"max_abs_err {r['err']}")
        src, rep = sources[name]
        out.append(dict(name=name, route="cuda", source=f"niagara_tpu_torch/csrc/{src}", replaces=rep,
                        max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bms, bound_by=by,
                        library_ms=None))
    return out


def profile_frames(tag, ds, tex, state, params, sp, cfg, frame, n: int = 5) -> None:
    """torch.profiler over n chained frames: device ops and kernel launches
    per frame, device busy time (union of device op intervals) and idle
    share of the host wall time, and the costliest device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            _, _, state, _ = frame.render_frame(ds, state, params, sp, cfg, textures=tex)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    check(device, "the profiler traced no device op")
    busy, (lo, hi) = 0, (device[0].time_range.start, device[0].time_range.end)
    for e in device[1:]:
        if e.time_range.start > hi:
            busy, lo = busy + hi - lo, e.time_range.start
        hi = max(hi, e.time_range.end)
    busy += hi - lo
    launch = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    log(tag, f"{n} frames, profiler on: host wall {wall_us / 1e3 / n:.3f} ms/frame, "
        f"{len(device) / n:.0f} device ops/frame, {len(launch) / n:.0f} kernel launches/frame "
        f"({sum(e.time_range.elapsed_us() for e in launch) / 1e3 / n:.3f} ms host), device busy "
        f"{busy / 1e3 / n:.3f} ms/frame, device idle share {1 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(tag, f"{us / 1e3 / n:9.4f} ms/frame  {name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
