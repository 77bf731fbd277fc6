#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (niagara_tpu_torch) on one GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
`python3 chip_smoke.py --baseline DIR` also builds the kernels of another
tree of the repository (DIR holds its niagara_tpu_torch/, e.g. an earlier
commit unpacked by `git archive` into the ignored .cache/) and times its
setup, raster, shade, trace and bloom wrappers against this tree's on the
same captured inputs, in turns (baseline, this tree, this tree, baseline);
for bloom also its chain a level a launch against this tree's chain.

Phases, each reported on its own line:
  device        -- needs CUDA (exits nonzero without it); prints the card's
                   name and power limit as nvidia-smi reports them;
  build         -- nvcc builds csrc/*.cu (one process per source, all at
                   once) while g++ builds the port's C++ cooker (and the
                   baseline tree's kernels, when given); each kernel's
                   registers, shared memory and spills from ptxas; the
                   city's preparation starts beside it (city scene);
  scene         -- the procedural mesh, 1,000,000 draws (the reference's
                   PCG scatter), uploaded to the card;
  small         -- a 256x128 frame of 48 draws through the kernels on the
                   card against the plain torch path on the CPU (the path
                   the CPU tests hold to the JAX reference);
  gate          -- the kernel-vs-plain gate (render/parity.py
                   kernel_parity_check): the small opaque and alpha frames
                   rendered on the card and every kernel instance replayed
                   against its plain twin bit for bit: both cull passes and
                   the pyramid, setup and raster (both variants, and a band
                   of each raster instance), shade, both G-buffers
                   (untextured and textured), the bloom levels and both
                   traces; what it held;
  warmup/main   -- the opaque headline path: two 1920x1080 frames from a
                   cold state (the second one's kernel inputs are kept),
                   then, with the launch counters at zero, three chained
                   frames through render_frame (frames 2-4, the steady
                   state): loss-free, finite, every kernel launched as often
                   as the frame calls it; the last frame's inputs are kept;
  kernels       -- the cull passes and the pyramid (csrc/cull.cu: draw
                   stage, cluster stage, both pyramid kernels), setup,
                   raster and shade replayed on the kept inputs of
                   the transitional frame 1 and the steady frame 4, each
                   against its plain torch version on the same inputs
                   through the package's replay (render/parity.py, the
                   gate's: bit for bit, since both round every op as
                   IEEE f32 and the kernels are built with --fmad=false), both timed with CUDA events
                   behind a spin kernel that hides the host's enqueue (and
                   the baseline's kernels, in turns); the steady frame's
                   G-buffer (gbuffer.cu, untextured) against its plain
                   twin, exact;
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
                   random ones must; the steady frame's G-buffer (textured,
                   with the alpha discard) against its plain twin, exact,
                   its time, bound and plain time;
  sun small     -- the small alpha scene with a 256x256 sun map: the static
                   map of all but its last three draws, then two frames that
                   move those three (the animated tail), update the map on
                   their dirty band (a partial one) and render shadowed;
                   kernels on the card against the plain path on the CPU;
  sun build     -- the benchmark's shadowed frame: the static 2048x2048 sun
                   map of the alpha scene's first 980,000 draws, 60 batches
                   of 16,384, loss-free;
  sun window    -- the animated tail's (the last 20,000 draws) dirty band,
                   and a forced mid-map band (tile rows 96-127): band rows
                   equal a full update's bit for bit, the bench band spliced
                   by pack_band equals a full repack, the forced band reports
                   the tail's pairs outside it;
  sun warmup/sun main -- the animated shadowed frame (bench.py:335-347): per
                   frame move the tail, update the band, splice it, render
                   with shadows; two cold frames, then three steady ones with
                   the counters at zero, loss-free, the window variant
                   launched once a frame, a shadowed share above 0;
  sun stages    -- one more animated frame from the steady state without
                   and with a StageTimer (utils/profiling.py) in the sun
                   update and render_frame: image, depth, vis, state, stats
                   and launches bit for bit; the stage table, each column
                   summing to the frame's ms within 5%;
  sun kernels   -- the window variant (both instances, tie merge) replayed
                   on the steady frame's band and on the forced band against
                   raster_plain, exact;
  bloom kernels -- the bloom chain (csrc/bloom.cu) on the alpha path's
                   steady frame-4 g0 at 1920x1080 with its emissive channel
                   replaced by seeded nonzero values (the scenes' own is 0):
                   bloom_down and bloom_up at every level, the tail
                   (bloom_tail from mip 4: every level it writes) and
                   bloom_x2 against their plain versions, bit for bit, then
                   compute_bloom and sample_bloom_fullres against the plain
                   chain; each launch's time alone, the frame's launches'
                   times, bounds, the library yardsticks (conv2d,
                   conv_transpose2d, interpolate), the down and up chain
                   (20 chains on the device, 100 back to back, the host's
                   enqueue) beside the chain a level a launch, and the
                   launches (10 a frame) and device time of one bloom a
                   frame under the profiler;
  mesh small    -- the sharded frame (parallel/mesh.py): the small alpha
                   scene with a 256x256 sun map of the unsharded scene, 4
                   shards in this process, two frames on the card against
                   the same 4 shards on the CPU: every shard's state, the
                   summed stats, gdepth, gvis, the owner masks and the sun
                   map exact, the image within 2e-6; then the small glass
                   scene the same way ("mesh small glass"), its merged
                   transmission layer exact too;
  mesh scene/mesh main -- the alpha frame's 1M draws in 4 round-robin shards
                   (materials only, as the reference's shard_draws), one
                   headline budget for every shard, the checker textures
                   and the static 2048^2 sun map of the unsharded scene,
                   bloom on, 1920x1080: two cold and three steady frames
                   with the counters at zero, loss-free, each kernel
                   launched 4 times a pass; the same as 1 shard; the
                   merged gdepth equal to render_frame's depth, the valid
                   masks equal, the image equal but where another draw wins
                   a depth tie (counted); frame ms, the merge's ms, peak
                   memory, the bytes reduced a frame;
  mesh kernels  -- the kernels replayed on shard 1 of the steady frame
                   (a nonzero fragment offset) against their plain versions;
  mesh profile  -- torch.profiler over five 4-shard frames;
  mesh dist     -- two processes (spawned, gloo, both on cuda:0) each
                   holding one shard of the opaque 1M-draw frame, three
                   frames through the Distributed collective, against the
                   same 2 shards in this process: image, gdepth, gvis,
                   stats and each rank's state bit for bit; the route the
                   reductions took (gloo's all_reduce on the card's tensors);
  glass small   -- the small scene as cooker.small_glass_scene makes it
                   (material 6's draws in the transmission class, materials
                   0-3 normal-mapped), post_passes=3, two 256x128 frames,
                   kernels on the card against the plain path on the CPU,
                   the transmission layer's depth and vis too;
  glass scene   -- the glass frame: cooker.glass_scene of the 1M draws
                   (125,000 transmission draws, 125,000 alpha draws, normal
                   maps on materials 0-3), uploaded to the card;
  glass warmup/glass main -- that frame (post_passes=3, unshadowed) as the
                   paths above: two cold frames, then three steady ones with
                   the counters at zero, loss-free, three setups (the alpha
                   variant), two opaque rasters (early pass and the layer),
                   one alpha_test raster and two shades (main, one-stream
                   layer) a frame; each late group's demand, the candidates,
                   the layer's covered and blended pixels;
  glass kernels -- every pass's setup and raster, both shades and both
                   G-buffers (gbuffer.cu, the normal map's tangent frame)
                   replayed on a transitional and a steady glass frame,
                   exact; the G-buffers' time, bound and plain time;
  configs small -- configs 0 and 1 (one pass, no late pass) on the small
                   scene at 256x128, kernels on the card against the CPU;
  configs       -- the viewer (niagara_tpu_torch.render_scene.run) at
                   1920x1080 with --config 0, 1 and 2, two frames each of
                   CONFIG_DRAWS torus draws from a camera file in front of
                   the first draw, the counters at zero before each: config
                   0 loss-free with every draw rendered, configs 1 and 2
                   equal in depth, the PNGs written with the HUD, the camera
                   file read back equal; config 0 at one draw past the
                   candidate budget drops draws; config 0's kernels
                   replayed against their plain versions;
  obj cache     -- a user's .obj through the scene cache
                   (cooker.cook_or_load): the procedural torus's .obj in a
                   fresh directory under .cache/ cooked cold (a miss; its
                   seconds), then warm (a hit; its seconds), the arrays equal
                   byte for byte, a miss after os.utime of the .obj; then
                   the viewer on that .obj at its defaults (10,000 draws,
                   1920x1080, 4 frames), its scene cache cold, then warm,
                   the counters at zero before each: every frame's kernels
                   launched, the last frame loss-free and finite; frame ms
                   (CUDA events) and the seconds to the first frame;
  entry         -- entry() (niagara_tpu_torch/entry.py) on the card, two
                   frames with the counters at zero, against entry on the
                   CPU: stats, state, vis and depth equal, the image within
                   2e-6; dryrun_multichip(4) on the card (4 shards in this
                   process), its printed line checked, against the same dry
                   run on the CPU;
  city small    -- the reduced glTF city (16 blocks) through the .glb ->
                   cook -> DDS -> bake -> table path, two 256x128 frames from
                   its camera with bloom on, kernels on the card against the
                   plain path on the CPU;
  city scene    -- the procedural city at bench.py's defaults (42 blocks),
                   generated and cooked cold in a worker process, then
                   loaded from its scene cache, decoded (no texture may fall
                   back to magenta), baked and tabled on a worker thread,
                   both started at startup, so it overlaps the paths above;
                   uploaded to the card;
  city warmup/city main -- bench.py's glTF frame (bench.py:393-459):
                   1920x1080, post_passes=2, presets.scene_capacities, the
                   scene's camera and sun, bloom on; two cold frames, then
                   three steady ones with the counters at zero, loss-free
                   (pair_drop_vec too), demand beside the reference's counts;
  city kernels  -- setup, raster and shade replayed on the city's
                   transitional and steady frames, exact;
  rt small      -- the small scene ray-traced (FrameConfig.shadows with a
                   ShadowBVH of its draws, ops/shadow.py), two 256x128
                   frames, kernels on the card against the plain path on the
                   CPU: stats, state, vis, depth and every traced flag
                   exact, the shadow term and image within 2e-6; "rt alpha
                   small" the small alpha scene with the quality-1 any-hit;
  rt scene/rt main -- bench.py's BENCH_SHADOW block on the opaque 1M-draw
                   frame: build_scene_rt and refit_tlas on the host (timed,
                   as bench.py prints "TLAS build" and "refit"), the BVH
                   uploaded; then five chained frames of
                   render_frame(bvh=...) from the steady state with the
                   counters at zero: loss-free, shadow and light in the
                   covered pixels, one trace launch a frame;
  rt kernels    -- the last of those frames' rays replayed: the kernel
                   (csrc/trace.cu, trace_any_hit<false>, the rays in the
                   frame's Morton order) against trace_plain on the card,
                   on the card's grid and on one block (its warps refill
                   many times), every flag and step count equal; rays,
                   steps per ray, the share out of budget, the walk's SIMD
                   efficiency in 32-ray groups (id order and ray order),
                   kernel and plain times (with --baseline, the baseline's
                   kernel in turns on the same rays), the bound from
                   trace_plain's counters; then trace_any_hit<true> on the
                   rays of "rt alpha": the alpha frame's 1M draws with
                   their masks, three frames with the quality-1 any-hit
                   (one trace_alpha launch a frame);
  profile       -- torch.profiler over five more frames of each path (and
                   of the sun path's update + splice alone): device ops and
                   kernel launches per frame, device busy time and idle
                   share, the bloom kernels' launches and time, the
                   costliest device ops.
Loss-free frames and the launch counts of the 1M-draw paths are checked in
"main", "alpha main" and "sun main" (and in the later paths' own main
phases); a stage table summing to the frame's ms in "sun stages".  Every
path renders with bloom on, as bench.py does.  The line before the
last is the per-kernel JSON record (times, launches and bounds of the
steady frames; a row also holds the kernel's numbers on other paths
under "alpha_path", "glass_path", "configs_path", "city_path" and
"mesh_path", the last per frame of one shard with the launches of all
four); the
last line is
{"ok": true, "device": ...}.  Any failed check raises (nonzero exit).
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

DROPS = ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped")
INVALID = 0x7FFFFFFF
# shade.cu's f32 operations per covered pixel (weights, six interpolated
# channels, uv/pixel areas); setup's and raster's counts, the work they
# need and the H100's peaks are the benchmark's (framebench/core/work.py)
SHADE_OPS = 70
# clock cycles of the spin kernel ahead of each timed launch (~1 ms at the
# H100's 1.98 GHz boost clock)
SPIN_CYCLES = 2_000_000
# the benchmark's sun map (bench.py:64-66, 143-266): 2048^2, static draws in
# batches of 16,384, the last 2% of the draws animated
SUN_MAP, SUN_BATCH = 2048, 1 << 14
# bloom.cu's f32 operations per output texel and channel: 36 taps (down),
# 16 taps and the accumulate (up), 4 taps (x2), a multiply and an add each
BLOOM_OPS = {"bloom_down": 72, "bloom_up": 33, "bloom_x2": 8}
# the reference's bloom is no Pallas kernel: each kernel replaces a plain
# XLA stencil function; the tail replaces compute_bloom's loop over the
# small levels (`_down2` and `_up2` + the accumulate there)
BLOOM_REPLACES = {"bloom_down": "niagara_tpu/ops/bloom.py:95", "bloom_up": "niagara_tpu/ops/bloom.py:119",
                  "bloom_tail": "niagara_tpu/ops/bloom.py:160", "bloom_x2": "niagara_tpu/ops/bloom.py:180"}
# the procedural city: bench.py's (defaults of synth_city.generate_city)
# and tests/test_city.py's reduced one, under the ignored .cache/
ROOT = os.path.dirname(os.path.abspath(__file__))
CITY_DIR, CITY_SMALL_DIR = os.path.join(ROOT, ".cache", "city"), os.path.join(ROOT, ".cache", "city_small")
CITY_SMALL = dict(blocks=4, facade_seg=8, tex_size=64)
# the reference's city counts (BENCH_r05, its frame 7; counts only)
CITY_REFERENCE = ("15,876 draws, 289,025 meshlets, 312 materials, 312 textures, 5,292 alpha draws; tri demand "
                  "1,857/131,072, pairs 77,292/262,144, class demand [31, 69, 149, 1013, 445, 150], giant cap 256")
# trace.cu's f32 operations per unit of a ray's walk, counted from the
# source: a node step (slab test: 6 sub, 6 mul, 6 min/max, 6 min/max for
# tnear/tfar, a compare), a triangle test (two crosses, four dots, a
# division, 3 sub, 5 compares and an add), an instance entry (two
# conjugate rotations, 3 sub, 6 divisions), a mask test (the hit's uv,
# two cells); the bytes of each row it reads, and a ray's own: origin and
# direction in, flag and step count out
TRACE_OPS = {"nodes": 25, "tris": 52, "instances": 69, "masks": 24}
TRACE_ROW_BYTES = {"nodes": 32, "tris": 48, "instances": 48, "masks": 64}
TRACE_RAY_BYTES = 24 + 1 + 4
# gbuffer.cu's f32 operations, counted from the source: a valid pixel
# (normalize, mip, emissive, srgb encode, oct encode), a texture sample
# (addressing, four unorms and the bilinear blend of four channels, the
# srgb decode), a bent normal (four world positions, the tangent frame,
# the mapped normal)
GBUFFER_OPS = {"pixel": 60, "sample": 60, "bend": 150}
# the render size of the glass, configs and mesh paths
FULL = (1920, 1080)
# the sharded frame's shards in one process
MESH_SHARDS = 4
# the configs path: torus draws and the camera's distance in front of the
# first draw.  Config 0 expands each draw's 1,089 LOD-0 meshlets (the
# torus's) against the viewer's candidate budget of 65,536 clusters: up to
# 60 draws fit; 48 leave 20% headroom
CONFIG_DRAWS, CONFIG_VIEW = 48, 12.0
STARTED = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of a phase, after the seconds since the script started
    (the city's host preparation runs on a thread beside the paths, so a
    path's host-bound frame times depend on when it runs)."""
    print(f"[{phase}] {time.perf_counter() - STARTED:.1f} s | {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def launch_counts(**counts) -> dict:
    """Every kernel's launch counter (_build.LAUNCHES), 0 but for `counts`."""
    from niagara_tpu_torch import _build

    check(set(counts) <= set(_build.LAUNCHES), f"unknown kernels {sorted(set(counts) - set(_build.LAUNCHES))}")
    return {k: counts.get(k, 0) for k in _build.LAUNCHES}


def bloom_launches(frames: int, size: tuple[int, int] = FULL) -> dict:
    """bloom.cu's launches over `frames` frames at size (width, height): a
    bloom_down and a bloom_up for each level above the tail's start, one
    bloom_tail (when two levels or more are left) and one bloom_x2 a frame.
    At 1920x1080 that is 4 + 4 + 1 + 1 (the tail from mip 4); at 256x128
    1 + 1 + 1 + 1 (the tail from mip 1)."""
    from niagara_tpu_torch.ops import bloom

    levels = bloom.bloom_levels(*size)
    start = min(bloom.tail_start(levels, (size[1] + 1) // 2, (size[0] + 1) // 2), levels - 1)
    return {"bloom_down": start * frames, "bloom_up": start * frames,
            "bloom_tail": frames if levels - start >= 2 else 0, "bloom_x2": frames}


def cull_launches(frames: int, late_groups: int = 1, two_pass: bool = True) -> dict:
    """cull.cu's launches over `frames` frames: a draw_cull and a
    cluster_cull a cull pass (the early pass, and the late pass of a
    two-pass frame), a cluster_order a class group (one early,
    `late_groups` late) and the two pyramid kernels a two-pass frame."""
    passes = 2 if two_pass else 1
    return {"draw_cull": passes * frames, "cluster_cull": passes * frames,
            "cluster_order": (1 + (late_groups if two_pass else 0)) * frames,
            "pyramid_base": frames if two_pass else 0, "pyramid_filter": frames if two_pass else 0}


def zero_launches() -> None:
    """Every kernel's launch counter (_build.LAUNCHES) to 0."""
    from niagara_tpu_torch import _build

    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def ptxas_resources(log: str) -> list[str]:
    """One line per kernel entry of an `nvcc -Xptxas=-v` log: registers,
    shared memory, stack and spills."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("setup_kernel", "setup_scatter", "setup_count", "setup_scan", "raster_tile",
                                     "shade_px", "bloom_down", "bloom_up", "bloom_tail", "bloom_x2",
                                     "trace_any_hit", "gbuffer_px")
                         if k in mangled), mangled)
            flags = re.findall(r"Lb([01])E", mangled)
            name += f"<{', '.join('true' if f == '1' else 'false' for f in flags)}>" if flags else ""
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {smem.group(1) if smem else 0} B smem, "
                       f"{spill}")
            name = None
    return out


def load_baseline(path: str, name: str = "baseline_niagara_tpu_torch"):
    """The _build, ops.setup, ops.raster_tile, ops.shadow and ops.bloom
    modules of another tree's niagara_tpu_torch, imported as package
    `name` (its relative imports stay inside it; its kernels build into
    its own build/)."""
    pkg = os.path.join(os.path.abspath(path), "niagara_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.{m}") for m in ("_build", "ops.setup", "ops.raster_tile",
                                                                  "ops.shadow", "ops.bloom"))


def in_turns(new_fn, old_fn, reps: int) -> tuple[float, float | None]:
    """(ms of new_fn, ms of old_fn or None): old, new, new, old, each the
    mean over reps launches, each side the mean of its two."""
    if old_fn is None:
        return cuda_ms(new_fn, reps), None
    o1, n1, n2, o2 = cuda_ms(old_fn, reps), cuda_ms(new_fn, reps), cuda_ms(new_fn, reps), cuda_ms(old_fn, reps)
    return (n1 + n2) / 2, (o1 + o2) / 2


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up.
    A spin kernel of about a millisecond a launch runs first, so the host
    enqueues the launches while the device is busy and the events time the
    device's work, not the wrappers' Python (a shade launch takes less
    device time than its wrapper takes on the host)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds to enqueue fn() (its wrappers' Python and
    launches), reps times while a spin kernel keeps the device busy."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / reps


def chain_times(new_fn, old_fn) -> dict:
    """A chain of launches (new_fn, and old_fn in turns when given): device
    ms of 20 chains behind the spin kernel (the launch queue holds them
    all, so the events see the device's time), ms of 100 chains back to
    back (past the launch queue's depth the host's enqueue paces them) and
    the host's ms to enqueue one chain."""
    dev, dev_old = in_turns(new_fn, old_fn, 20)
    b2b, b2b_old = in_turns(new_fn, old_fn, 100)
    return dict(ms=dev, ms_100=b2b, host_ms=host_ms(new_fn, 20),
                **({"old_ms": dev_old, "old_ms_100": b2b_old, "old_host_ms": host_ms(old_fn, 20)} if old_fn else {}))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least milliseconds the card could take (the benchmark's
    work.bound_ms: bytes over the HBM rate or operations over the f32
    rate, the larger) and which one it is."""
    from framebench.core import work

    by = "bytes" if nbytes / work.HBM_BYTES_S >= ops / work.F32_OPS_S else "operations"
    return work.bound_ms(nbytes, ops), by


def frame_line(s: dict) -> str:
    return (f"visible_draws {int(s['visible_draws'])} early/late draws {int(s['early_commands'])}/"
            f"{int(s['late_commands'])} clusters {int(s['early_clusters'])}/{int(s['late_clusters'])} "
            f"candidates {int(s['candidates'])} tris {int(s['tri_count'])} pairs {int(s['pair_count'])} "
            f"drops {[int(s[k]) for k in DROPS]} pair_demand {s['pair_demand_vec'].tolist()} "
            f"pair_drops {s['pair_drop_vec'].tolist()}")


def pass_line(capture: dict) -> str:
    """Clusters, triangles and pairs per pass of a captured frame, and the
    post classes' share of each (alpha, or glass in its own pass)."""
    parts = []
    for name, (tc, _), (ts, pt, rec, *_), st in zip(capture["passes"], capture["setup"], capture["raster"],
                                                   capture["setup_out"]):
        k, n, p = int(tc["count"][0]), int(st["count"]), int(ts[-1])
        post = rec[:n, 45] > 0
        parts.append(f"{name}: {k} clusters ({int((tc['post_pass'][:k] > 0).sum())} post), {n} tris "
                     f"({int(post.sum())} post), {p} pairs ({int((rec[pt[:p].long(), 45] > 0).sum())} post)")
    return "; ".join(parts)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="End-to-end check of niagara_tpu_torch on one GPU")
    ap.add_argument("--baseline", help="another tree of the repository whose kernels to time beside this one's")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false -- this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from niagara_tpu_torch import _build
    from niagara_tpu_torch.cooker import bindings

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    base = load_baseline(opts.baseline) if opts.baseline else None
    # the city's preparation is host work (generation, the C++ cook, DDS
    # decode, bake): it runs on its own thread from here on, the cook in a
    # process of its own, beside the build and the paths on the card, and
    # is collected in the city scene phase
    city_pool = ThreadPoolExecutor(1)
    cook_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        city_job = city_pool.submit(prepare_city, CITY_DIR, {}, cook_pool)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(_build.lib), pool.submit(bindings.get_lib)] + (
                [pool.submit(base[0].lib)] if base else [])
            for j in jobs:
                j.result()
        log("build", f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_info['seconds']}) -> "
            f"{_build.build_info['path']}, cooker {bindings.lib_path()}")
        for line in ptxas_resources(_build.build_info["log"]):
            log("build", f"ptxas {line}")
        if base:
            log("build", f"baseline {opts.baseline}: {base[0].build_info['path']}")
            for line in ptxas_resources(base[0].build_info["log"]):
                log("build", f"baseline ptxas {line}")
        kernels = run_all(base, city_job, dev, smi)
    finally:
        city_pool.shutdown(wait=True, cancel_futures=True)
        cook_pool.shutdown(wait=True, cancel_futures=True)
    torch.cuda.empty_cache()

    order = ("draw_cull", "cluster_cull", "pyramid_base", "setup", "setup_alpha", "raster", "raster_alpha",
             "raster_alpha_window", "shade", "gbuffer", "bloom_down", "bloom_up", "bloom_tail", "bloom_x2", "trace",
             "trace_alpha")
    check(set(kernels) == set(order), f"kernel rows {sorted(kernels)}")
    print(smi)
    print(json.dumps({"kernels": [kernels[n] for n in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def run_gate(geometry, dev) -> None:
    """The gate (render/parity.py kernel_parity_check) on the card: the
    small opaque and alpha frames, every kernel instance replayed against
    its plain twin bit for bit (it raises on the first differing word);
    then that it held every instance, the bloom levels and both traces."""
    from niagara_tpu_torch.render import parity

    t0 = time.perf_counter()
    held = parity.kernel_parity_check(geometry, dev)
    log("gate", f"every kernel bit for bit against its plain version in {time.perf_counter() - t0:.1f} s; the gate "
        f"held {held}")
    check(set(held["calls"]) == {"cull", "pyramid", "setup", "setup_alpha", "raster", "raster_alpha", "raster_window",
                                 "raster_alpha_window", "shade", "gbuffer"} and held["bloom_levels"] > 0
          and held["rays"] > 0, f"the gate did not replay every kernel instance: {held}")


def run_all(base, city_job, dev, smi) -> dict:
    """Every phase after the build; returns the per-kernel rows."""
    import torch

    from niagara_tpu_torch import _build, cooker, scene
    from niagara_tpu_torch.ops import bloom, raster_tile, setup, shadow, sunmap
    from niagara_tpu_torch.render import camera, frame, presets, textures

    t0 = time.perf_counter()
    geometry = cooker.cook_procedural()
    draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=1_000_000)
    ds = scene.from_numpy(scene.upload(geometry, draws), dev)
    torch.cuda.synchronize()
    log("scene", f"{ds.num_draws} draws, {ds.num_meshlets} meshlets, lod0 triangles "
        f"{int(geometry.meshes.lod_index_count[0, 0]) // 3}, {time.perf_counter() - t0:.1f} s")

    small_draws = cooker.small_scene_draws(geometry.meshes.count)
    small_reference("small", dev, scene.upload(geometry, small_draws), None,
                    frame.FrameConfig(width=256, height=128, **presets.small_capacities()), scene, camera, frame)
    run_gate(geometry, dev)

    cfg = frame.FrameConfig(width=1920, height=1080, **presets.headline_capacities(ds.num_draws))
    expected = launch_counts(setup=6, raster=6, shade=3, gbuffer=3, **bloom_launches(3), **cull_launches(3))
    opaque = run_path("", ds, None, cfg, dev, frame, camera, _build, expected, smi)
    compare_kernels("", "transitional frame 1", opaque["transitional"], ds, opaque["params"], cfg, setup, raster_tile)
    rows = compare_kernels("", "steady frame 4", opaque["steady"], ds, opaque["params"], cfg, setup, raster_tile,
                           base)
    kernels = {r["name"]: dict(r, path="opaque", launches=opaque["launches"][r["name"]]) for r in rows}
    compare_gbuffer("", "steady frame 4", opaque["steady"], ds, None, opaque["sp"])
    profile_frames("profile", lambda st, i: frame.render_frame(ds, st, opaque["params"], opaque["sp"], cfg)[2],
                   opaque["state"])

    # the ray-traced frame: the opaque frame shadowed through the BVH of its
    # draws (bench.py:363-390, BENCH_SHADOW), from its steady state
    small_reference("rt small", dev, scene.upload(geometry, small_draws), None,
                    frame.FrameConfig(width=256, height=128, shadows=True, **presets.small_capacities()),
                    scene, camera, frame, bvh=shadow.build_scene_rt(geometry, small_draws)[0])
    per_frame = launch_counts(setup=2, raster=2, shade=1, gbuffer=1, trace=1, **bloom_launches(1),
                              **cull_launches(1))
    rt = run_rt("rt", ds, geometry, draws, None, cfg, opaque["state"], opaque["params"], opaque["sp"], dev, frame,
                shadow, _build, smi, per_frame, 5)
    kernels["trace"] = dict(compare_trace("rt kernels", "steady frame", rt["bvh"], rt["trace"], shadow, base),
                            path="rt", launches=rt["launches"]["trace"])
    profile_frames("rt profile", lambda st, i: frame.render_frame(ds, st, opaque["params"], opaque["sp"], rt["cfg"],
                                                                 bvh=rt["bvh"])[2], rt["state"])
    del ds, opaque, rt
    torch.cuda.empty_cache()

    # the textured, alpha-classed frame.  The city's preparation thread
    # holds the interpreter lock for seconds at a time near its end (decode,
    # bake, layout), which stalled host-bound frames by up to 1.7 s and the
    # profiled ones by 7x: from here on the paths run after it
    city_job.result()
    ga, da, mats, masks, mips = cooker.small_alpha_scene(geometry)
    small_table = textures.build_texture_table(mips)
    small_reference("alpha small", dev, scene.upload(ga, da, mats, masks, texture_table=small_table), small_table,
                    frame.FrameConfig(width=256, height=128, post_passes=2, **presets.small_capacities()),
                    scene, camera, frame)
    small_reference("rt alpha small", dev, scene.upload(ga, da, mats, masks, texture_table=small_table), small_table,
                    frame.FrameConfig(width=256, height=128, post_passes=2, shadows=True, shadow_quality=1,
                                      **presets.small_capacities()),
                    scene, camera, frame, bvh=shadow.build_scene_rt(ga, da, mats, mips)[0])

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
    expected = launch_counts(setup_alpha=6, raster=3, raster_alpha=3, shade=3, gbuffer=3, **bloom_launches(3),
                             **cull_launches(3))
    alpha = run_path("alpha ", ds, tex, cfg, dev, frame, camera, _build, expected, smi)
    compare_kernels("alpha ", "transitional frame 1", alpha["transitional"], ds, alpha["params"], cfg, setup,
                    raster_tile)
    rows = compare_kernels("alpha ", "steady frame 4", alpha["steady"], ds, alpha["params"], cfg, setup, raster_tile,
                           base)
    for r in rows:
        if r["name"] in ("setup_alpha", "raster_alpha"):
            kernels[r["name"]] = dict(r, path="alpha", launches=alpha["launches"][r["name"]])
        elif r["name"] == "shade":  # one row per kernel: shade's alpha-path numbers ride in its opaque row
            kernels["shade"]["alpha_path"] = side_row(r, alpha["launches"]["shade"])
    kernels["gbuffer"] = dict(compare_gbuffer("alpha ", "steady frame 4", alpha["steady"], ds, tex, alpha["sp"]),
                              path="alpha", launches=alpha["launches"]["gbuffer"])
    for r in compare_bloom("bloom kernels", alpha["steady"]["g0"], cfg.width, cfg.height, bloom, base):
        kernels[r["name"]] = dict(r, path="alpha", launches=alpha["launches"][r["name"]])
    profile_frames("alpha profile", lambda st, i: frame.render_frame(ds, st, alpha["params"], alpha["sp"], cfg,
                                                                    textures=tex)[2], alpha["state"])
    # the alpha frame ray-traced with the quality-1 any-hit through the masks
    per_frame = launch_counts(setup_alpha=2, raster=1, raster_alpha=1, shade=1, gbuffer=1, trace_alpha=1,
                              **bloom_launches(1), **cull_launches(1))
    rta = run_rt("rt alpha", ds, ga, da, tex, cfg, alpha["state"], alpha["params"], alpha["sp"], dev, frame, shadow,
                 _build, smi, per_frame, 3, mats=mats, mips=mips)
    kernels["trace_alpha"] = dict(compare_trace("rt kernels", "alpha steady frame", rta["bvh"], rta["trace"], shadow,
                                                base),
                                  path="rt alpha", launches=rta["launches"]["trace_alpha"])
    del alpha, rta
    torch.cuda.empty_cache()

    # the shadowed, animated textured frame: the sun map
    sun_small("sun small", dev, geometry, scene, camera, frame, presets, textures, sunmap, cooker)
    cfg = frame.FrameConfig(width=1920, height=1080, post_passes=2, shadows=True,
                            **presets.headline_capacities(ds.num_draws))
    sun = run_sun(ds, da, tex, cfg, dev, frame, camera, presets, sunmap, _build, smi)
    kernels["raster_alpha_window"] = dict(compare_window("sun kernels", sun, raster_tile, base), path="sun",
                                          launches=sun["launches"]["raster_alpha_window"])
    profile_frames("sun profile", lambda st, i: sun["step"](st, 0.3 * (i + 6))[0][2], sun["state"])
    profile_frames("sun update profile", lambda st, i: sun["update_step"](0.3 * (i + 11))[1], None)
    del ds, tex, sun
    torch.cuda.empty_cache()

    # the sharded frame: the alpha scene's draws in 4 shards on this card,
    # then 2 gloo ranks sharing it
    run_mesh(kernels, geometry, ga, da, mats, mips, dev, smi)
    torch.cuda.empty_cache()
    run_mesh_dist(geometry, draws.count, dev, smi)
    torch.cuda.empty_cache()

    # the glass frame: the alpha frame with a transmission class and
    # normal maps (post_passes=3)
    run_glass(kernels, geometry, draws, dev, smi, base)
    torch.cuda.empty_cache()

    # the viewer's configs 0, 1 and 2 (single-pass and two-pass occlusion)
    run_configs(kernels, dev, smi)
    torch.cuda.empty_cache()

    # a user's .obj through the scene cache and the viewer; the entry
    # points: entry() and the sharded dry run
    run_obj_cache(dev, smi)
    run_entry(dev, smi)
    torch.cuda.empty_cache()

    # the procedural glTF city: reduced, then at bench.py's size
    small = prepare_city(CITY_SMALL_DIR, CITY_SMALL)
    sd = small["sd"]
    small_reference("city small", dev, small["scene"], small["table"],
                    frame.FrameConfig(width=256, height=128, post_passes=2,
                                      **presets.scene_capacities(sd.geometry, sd.draws)),
                    scene, camera, frame, cam=camera.Camera(position=sd.camera_position,
                                                            orientation=sd.camera_orientation),
                    sun_direction=sd.sun_direction)
    t0 = time.perf_counter()
    city = city_job.result()
    waited = time.perf_counter() - t0
    sd = city["sd"]
    t0 = time.perf_counter()
    ds = scene.from_numpy(city["scene"], dev)
    tex = textures.to_device(city["table"], dev)
    torch.cuda.synchronize()
    log("city scene", f"{sd.draws.count} draws, {ds.num_meshlets} meshlets, {len(sd.materials['diffuse'])} materials, "
        f"{len(sd.texture_paths)} textures, {int((sd.draws.post_pass == 1).sum())} alpha draws, texel pool "
        f"{city['table'].texels.shape[0]}, 0 of {len(sd.texture_paths)} textures substituted | seconds on the worker "
        f"thread: {city['seconds']}; waited {waited:.1f} s for it, upload {time.perf_counter() - t0:.1f} s | the "
        f"reference: {CITY_REFERENCE}")
    caps = presets.scene_capacities(sd.geometry, sd.draws)
    cfg = frame.FrameConfig(width=1920, height=1080, post_passes=2, **caps)
    log("city scene", f"capacities {caps}")
    expected = launch_counts(setup_alpha=6, raster=3, raster_alpha=3, shade=3, gbuffer=3, **bloom_launches(3),
                             **cull_launches(3))
    cam = camera.Camera(position=sd.camera_position, orientation=sd.camera_orientation)
    path = run_path("city ", ds, tex, cfg, dev, frame, camera, _build, expected, smi, cam=cam,
                    sun_direction=sd.sun_direction)
    s = path["stats"]
    log("city main", f"frame 4 demand: tris {int(s['tri_count'])}/{cfg.tri_capacity} (late {cfg.late_tri_cap}), pairs "
        f"{int(s['pair_count'])}/{cfg.pair_capacity} (late {cfg.late_pair_cap}), class demand "
        f"{s['pair_demand_vec'].tolist()} (giant capacity {cfg.giant_capacity}), pair drops "
        f"{s['pair_drop_vec'].tolist()} | the reference: {CITY_REFERENCE}")
    compare_kernels("city ", "transitional frame 1", path["transitional"], ds, path["params"], cfg, setup,
                    raster_tile)
    rows = compare_kernels("city ", "steady frame 4", path["steady"], ds, path["params"], cfg, setup, raster_tile)
    for r in rows:
        kernels[r["name"]]["city_path"] = side_row(r, path["launches"][r["name"]])
    profile_frames("city profile", lambda st, i: frame.render_frame(ds, st, path["params"], path["sp"], cfg,
                                                                   textures=tex)[2], path["state"])
    return kernels


def mesh_small(tag, dev, g, d, mats, mips, cfg, n: int = 4) -> None:
    """A small scene as n in-process shards (materials only, the textures
    and, with cfg.shadows, a 256^2 sun map of the unsharded scene given to
    the frame), two frames on the card against the same shards on the CPU:
    every shard's state, the summed stats, gdepth, gvis, the owner masks,
    the sun map and, with post_passes=3, the merged layer exact; the image
    within 2e-6."""
    import torch

    from niagara_tpu_torch.ops import sunmap
    from niagara_tpu_torch.parallel import mesh
    from niagara_tpu_torch.render import camera, frame, textures

    table = textures.build_texture_table(mips)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    runs = {}
    for where in ("cpu", dev):
        scenes = mesh.shard_draws(g, d, n, mats, device=where)
        tex = textures.to_device(table, where)
        sun = None
        if cfg.shadows:
            sf = sunmap.fit_sun_to_draws(sp.sun_direction, d, device=where)
            static, drop = sunmap.build_static_sun_map(mesh.shard_draws(g, d, 1, mats, device=where)[0], sf, batch=16,
                                                       num_draws=d.count, map_w=256, map_h=256, cmd_capacity=256,
                                                       cluster_capacity=1024, tri_capacity=1 << 14,
                                                       pair_capacity=1 << 15)
            check(int(drop) == 0, "the small sun map dropped work")
            sun = (sf, sunmap.pack_sun_map(static), (256, 256))
        states = mesh.init_sharded_state(scenes)
        for _ in range(2):
            cap = {}
            img, fb, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, mesh.InProcess(),
                                                               textures=tex, sun=sun, capture=cap)
        runs[str(where)] = dict(img=img.cpu(), depth=fb.depth.cpu(), vis=fb.vis.cpu(), stats=stats.to_dict(),
                                mine=[m.cpu() for m in cap["mine"]], states=[frame.state_to_numpy(x) for x in states],
                                map=None if sun is None else sun[1].cpu(),
                                layer=cap["layer"] and {k: v.cpu() for k, v in cap["layer"].items()})
    c, k = runs["cpu"], runs[str(dev)]
    check(all(np.array_equal(c["stats"][f], k["stats"][f]) for f in c["stats"]), f"{tag}: summed stats differ")
    check(all(np.array_equal(x, y) for a, b in zip(c["states"], k["states"]) for x, y in zip(a, b)),
          f"{tag}: a shard's state differs")
    check(torch.equal(c["depth"], k["depth"]) and torch.equal(c["vis"], k["vis"]), f"{tag}: gdepth/gvis differ")
    check(all(torch.equal(a, b) for a, b in zip(c["mine"], k["mine"])), f"{tag}: owner masks differ")
    check(c["map"] is None or torch.equal(c["map"], k["map"]), f"{tag}: sun maps differ")
    extra = ""
    if c["layer"]:
        check(all(torch.equal(c["layer"][f], k["layer"][f]) for f in c["layer"]), f"{tag}: the merged layer differs")
        extra = f", merged transmission layer equal ({int((c['layer']['vis'] != INVALID).sum())} px)"
    check(all(int(c["stats"][f]) == 0 for f in DROPS), f"{tag}: dropped work")
    image_err = float((c["img"] - k["img"]).abs().max())
    owned = [int(m.sum()) for m in c["mine"]]
    log(tag, f"{n} shards of {d.count} draws, 256x128, two frames, kernels on {dev} vs plain on cpu: states, stats, "
        f"gdepth, gvis, owner masks{' and sun map' if c['map'] is not None else ''} equal; pixels owned per shard "
        f"{owned}; image max_abs_err {image_err:.3g} (tolerance 2e-6){extra}")
    check(image_err <= 2e-6 and min(owned) > 0, f"{tag}: image differs or a shard owns no pixel")


def mesh_frames(tag, scenes, states, cfg, params, sp, tex, sun, expected, smi) -> dict:
    """Two cold and three steady sharded frames (InProcess), the counters
    at zero and the peak memory reset before the steady ones: each
    loss-free (the summed drop counters are 0, so every shard's are) and
    finite, the launches as `expected`.  Returns the last frame (image,
    framebuffer, capture, stats), the states before and after it, the
    frame times and the memory."""
    import torch

    from niagara_tpu_torch import _build
    from niagara_tpu_torch.parallel import mesh

    coll = mesh.InProcess()
    for i in range(2):
        _, _, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, coll, textures=tex, sun=sun)
        log(f"{tag} warmup", f"frame {i}: {frame_line(stats.to_dict())}")
    torch.cuda.synchronize()
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    frame_ms = []
    for i in range(3):
        cap = {} if i == 2 else None
        before = states
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        image, fb, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, coll, textures=tex,
                                                             sun=sun, capture=cap)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        s = stats.to_dict()
        log(f"{tag} main", f"frame {i + 2}: {frame_ms[-1]:.3f} ms | {frame_line(s)} covered_px "
            f"{int((fb.vis != INVALID).sum())}")
        check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), f"{tag} frame {i + 2} dropped work")
        check(tuple(image.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(image).all()),
              f"{tag}: image not finite")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} main", f"launches {launches} (expected {expected}); frame ms {frame_ms}; memory allocated "
        f"{resident / 2**30:.2f} GiB before the steady frames, peak {peak / 2**30:.2f} GiB on {smi}")
    check(launches == expected, f"{tag}: kernel launch counts")
    return dict(image=image, fb=fb, cap=cap, stats=s, before=before, states=states, launches=launches,
                frame_ms=frame_ms, peak=peak, resident=resident)


def run_mesh(kernels, geometry, ga, da, mats, mips, dev, smi) -> None:
    """The sharded frame (parallel/mesh.py).  mesh small: the small alpha
    and glass scenes in 4 shards, card against CPU.  mesh main: the alpha
    frame's 1M draws (ga, da, mats, mips: cooker.alpha_scene) in 4 shards
    on this card, one headline budget each, textured, with the static
    2048^2 sun map of the unsharded scene, bloom on, 1920x1080, against
    the same draws as 1 shard and render_frame; the kernels replayed on
    shard 1; the profile.  The path's launches and shard 1's kernel
    numbers ride in each kernel's row under "mesh_path"."""
    import torch

    from niagara_tpu_torch import cooker
    from niagara_tpu_torch.ops import raster_tile, setup, shade, shadow, sunmap
    from niagara_tpu_torch.parallel import mesh
    from niagara_tpu_torch.render import camera, frame, presets, textures

    small = presets.small_capacities()
    g, d, m, _, mp = cooker.small_alpha_scene(geometry)
    mesh_small("mesh small", dev, g, d, m, mp,
               frame.FrameConfig(width=256, height=128, post_passes=2, shadows=True, **small))
    g, d, m, _, mp = cooker.small_glass_scene(geometry)
    mesh_small("mesh small glass", dev, g, d, m, mp, frame.FrameConfig(width=256, height=128, post_passes=3, **small))

    n = MESH_SHARDS
    t0 = time.perf_counter()
    shards = {k: mesh.shard_draws(ga, da, k, mats, device=dev) for k in (n, 1)}
    tex = textures.to_device(textures.build_texture_table(mips), dev)
    cfg = frame.FrameConfig(width=FULL[0], height=FULL[1], post_passes=2, shadows=True,
                            **presets.headline_capacities(da.count))
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sf = sunmap.fit_sun_to_draws(sp.sun_direction, da, device=dev)
    static, drop = sunmap.build_static_sun_map(shards[1][0], sf, batch=SUN_BATCH, num_draws=da.count, map_w=SUN_MAP,
                                               map_h=SUN_MAP, texel_world=sunmap.map_texel_world(sf, SUN_MAP, SUN_MAP),
                                               cmd_capacity=cfg.cmd_capacity, cluster_capacity=cfg.cluster_capacity,
                                               tri_capacity=min(cfg.tri_capacity, 1 << 19),
                                               pair_capacity=cfg.pair_capacity)
    sun = (sf, sunmap.pack_sun_map(static), (SUN_MAP, SUN_MAP))
    torch.cuda.synchronize()
    check(int(drop) == 0, "the mesh path's sun map dropped work")
    log("mesh scene", f"{da.count} draws in {n} shards of {shards[n][0].num_draws} (and 1 of {da.count}), "
        f"{int((da.post_pass > 0).sum())} in the alpha class, no masks (materials only); frag_stride "
        f"{mesh.frag_stride(cfg)}; shards uploaded in {upload_s:.1f} s; static {SUN_MAP}^2 sun map of the "
        f"unsharded scene {time.perf_counter() - t0:.2f} s, covered texels {int((static > 0).sum())}")
    del static

    per_pass = dict(setup=2, raster=1, raster_alpha=1, shade=1, gbuffer=1)
    runs = {}
    for k in (n, 1):
        expected = launch_counts(**{name: 3 * k * c for name, c in per_pass.items()}, **bloom_launches(3),
                                 **cull_launches(3 * k))
        runs[k] = mesh_frames(f"mesh {k}-shard", shards[k], mesh.init_sharded_state(shards[k]), cfg, params, sp, tex,
                              sun, expected, smi)
    four, one = runs[n], runs[1]
    _, rfb, rstate, _ = frame.render_frame(shards[1][0], one["before"][0], params, sp, cfg, textures=tex, sun=sun)
    check(torch.equal(rfb.depth, one["fb"].depth) and torch.equal(rfb.vis, one["fb"].vis),
          "the 1-shard frame differs from render_frame")
    # each shard's depth pyramid holds only its own occluders, so it culls
    # no more than the single card's: gdepth is never farther, and where it
    # is nearer the single card's occlusion test culled a draw that is
    # visible there (its pyramid is not conservative at a one-pixel gap)
    draws4 = mesh.winning_draws(four["cap"], four["fb"].vis, n, cfg)
    draws1 = mesh.winning_draws(one["cap"], one["fb"].vis, 1, cfg)
    nearer = four["fb"].depth > rfb.depth
    check(not bool((four["fb"].depth < rfb.depth).any()), "the merged gdepth is farther than render_frame's somewhere")
    culled = torch.unique(draws4[nearer])
    won1 = torch.zeros(da.count, dtype=torch.bool, device=dev)
    won1[draws1[draws1 >= 0]] = True
    check(not bool(won1[culled].any()) and not bool(rstate.draw_vis[culled].any()),
          "a draw that renders nearer in the shards is visible in the single-card frame")
    check(torch.equal(four["cap"]["valid"][~nearer], one["cap"]["valid"][~nearer]), "the merged valid masks differ")
    # the depth-aware shadow blur carries a changed depth (half resolution,
    # SHADOW_BLUR_KERNEL taps and the gradient's neighbour) into the term
    reach = 2 * (shadow.SHADOW_BLUR_KERNEL + 1) + 1
    near_reach = torch.nn.functional.max_pool2d(nearer[None, None].float(), 2 * reach + 1, 1, reach)[0, 0] > 0
    ties = (draws4 != draws1) & ~nearer
    differ = (four["image"] != one["image"]).any(-1)
    check(torch.equal(draws4 >= 0, rfb.vis != INVALID), "winning draws do not cover the covered pixels")
    check(not bool((differ & ~ties & ~near_reach).any()), "the 4-shard image differs where the same draw wins")
    owned = [int(x.sum()) for x in four["cap"]["mine"]]
    log("mesh main", f"frame 4: gdepth equals render_frame's depth at {int((~nearer).sum())} of {nearer.numel()} px "
        f"and is nearer at {int(nearer.sum())} px (max {float((four['fb'].depth - rfb.depth).max()):.4g}), each won by "
        f"a draw the single card culled as occluded ({culled.numel()} draws: invisible in its state, winning no px); "
        f"valid masks equal elsewhere; pixels owned per shard {owned}; {int(ties.sum())} px won by another draw of "
        f"equal depth ({int((differ & ties).sum())} of them another colour); {int((differ & near_reach & ~ties).sum())} "
        f"px of another colour within the shadow blur's reach ({reach} px) of the nearer ones; the image equal "
        f"elsewhere")

    # the merge alone on the steady frame's shards: reductions, the owner
    # G-buffers with pack, the sum of the packed planes with unpack
    cap, coll, ivp = four["cap"], mesh.InProcess(), sp.inverse_view_projection
    depths, viss = [fb.depth for fb in cap["fbs"]], [fb.vis for fb in cap["fbs"]]
    gdepth, gvis, mine = mesh.sort_last(depths, viss, coll)
    check(torch.equal(gdepth, four["fb"].depth) and torch.equal(gvis, four["fb"].vis), "the merge is not reproducible")

    def owner_planes():
        return [shade.pack_gbuffer(*shade.gbuffer_from_attrs(a, o, sc, textures=tex, depth=gdepth,
                                                             inverse_view_projection=ivp))
                for a, o, sc in zip(cap["attrs"], mine, shards[n])]

    packed = owner_planes()

    def sum_unpack():
        return shade.unpack_gbuffer(coll.sum([p[0] for p in packed]), coll.sum([p[1] for p in packed]))

    def whole():
        dz, _, mz = mesh.sort_last(depths, viss, coll)
        return mesh.merge_gbuffer(cap["attrs"], mz, shards[n], coll, dz, ivp, tex)

    merged = whole()
    check(all(torch.equal(x, cap[k]) for x, k in zip(merged, ("g0", "g1", "valid"))), "the merged G-buffer differs")
    t = dict(sort_last=cuda_ms(lambda: mesh.sort_last(depths, viss, coll), 10), owner=cuda_ms(owner_planes, 5),
             sum_unpack=cuda_ms(sum_unpack, 10))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        whole()
    end.record()
    torch.cuda.synchronize()
    nbytes = mesh.allreduce_bytes_per_frame(cfg)
    log("mesh main", f"merge of {n} shards: {start.elapsed_time(end) / 5:.3f} ms a frame (CUDA events, host enqueue "
        f"included); device ms: depth max + id min {t['sort_last']:.4f}, owner G-buffers + pack {t['owner']:.4f}, sum "
        f"+ unpack {t['sum_unpack']:.4f}; allreduce_bytes_per_frame {nbytes} ({nbytes / 2**20:.1f} MiB a shard); "
        f"frame ms {n} shards {four['frame_ms']}, 1 shard {one['frame_ms']}; peak memory (max_memory_allocated) "
        f"{n} shards {four['peak'] / 2**30:.2f} GiB, {(four['peak'] - four['resident']) / 2**30:.2f} GiB above the "
        f"{four['resident'] / 2**30:.2f} resident before its steady frames; 1 shard {one['peak'] / 2**30:.2f} GiB, "
        f"{(one['peak'] - one['resident']) / 2**30:.2f} above {one['resident'] / 2**30:.2f} (the 4 shards' scenes "
        f"and states still resident) on {smi}")

    s1 = cap["shards"][1]
    off = mesh.frag_stride(cfg) * cap["shard_ids"][1]
    rows = compare_kernels("mesh ", f"steady frame 4 shard 1 (fragment offset {off})", s1, shards[n][1], params, cfg,
                           setup, raster_tile)
    for r in rows:
        kernels[r["name"]]["mesh_path"] = side_row(r, four["launches"][r["name"]])
    profile_frames("mesh profile", lambda st, i: mesh.render_sharded_frame(shards[n], st, params, sp, cfg, coll,
                                                                          textures=tex, sun=sun)[2], four["states"],
                   smi=smi)


def mesh_dist_rank(rank: int, world: int, port: int, out_dir: str, frames: int, device: str, size: tuple,
                   draw_count: int) -> None:
    """One rank of the mesh dist phase (spawned): joins the gloo group at
    tcp://localhost:`port`, takes shard `rank` of the opaque frame of
    `draw_count` synthesized draws at `size` on `device`, renders `frames`
    sharded frames through the Distributed collective (gloo's all_reduce
    on the tensors where they live) and writes the last one's image,
    gdepth, gvis, stats, its state, the route and the frame times to
    `out_dir`/rank<rank>.npz."""
    import torch
    import torch.distributed as dist

    from niagara_tpu_torch import cooker
    from niagara_tpu_torch.parallel import mesh
    from niagara_tpu_torch.render import camera, frame, presets

    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        route = f"{dist.get_backend()} all_reduce (max, min, sum) on {dev.type} tensors"
        coll = mesh.Distributed()
        geometry = cooker.cook_procedural()
        draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=draw_count)
        scenes = [mesh.shard_draws(geometry, draws, world, device=dev)[rank]]
        states = mesh.init_sharded_state(scenes)
        cfg = frame.FrameConfig(width=size[0], height=size[1], **presets.headline_capacities(draws.count))
        params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        frame_ms = []
        for _ in range(frames):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            image, fb, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, coll)
            end.record()
            torch.cuda.synchronize()
            frame_ms.append(start.elapsed_time(end))
        draw_vis, vis_words = frame.state_to_numpy(states[0])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), image=image.cpu().numpy(), depth=fb.depth.cpu().numpy(),
                 vis=fb.vis.cpu().numpy(), draw_vis=draw_vis, vis_words=vis_words, route=route,
                 frame_ms=np.array(frame_ms), **{f"stats_{k}": v for k, v in stats.to_dict().items()})
    finally:
        dist.destroy_process_group()


def run_mesh_dist(geometry, draw_count: int, dev, smi) -> None:
    """mesh dist: two spawned ranks (gloo, both on cuda:0), one shard each
    of the opaque frame of `draw_count` synthesized draws (made afresh, as
    each rank makes them: the alpha paths rewrite the classes of
    run_all's draws in place), three frames, against the same 2 shards in
    this process (run meanwhile): image, gdepth, gvis, stats and each
    rank's state bit for bit.  A rank that fails or outlives its time
    fails the phase; every rank is stopped before this returns."""
    import socket

    import torch
    import torch.multiprocessing as tmp

    from niagara_tpu_torch import cooker
    from niagara_tpu_torch.parallel import mesh
    from niagara_tpu_torch.render import camera, frame, presets

    world, frames = 2, 3
    draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=draw_count)
    out = os.path.join(ROOT, ".cache", "mesh_dist")
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ctx = tmp.start_processes(mesh_dist_rank, args=(world, port, out, frames, str(dev), FULL, draws.count),
                              nprocs=world, join=False, start_method="spawn")
    try:
        scenes = mesh.shard_draws(geometry, draws, world, device=dev)
        states = mesh.init_sharded_state(scenes)
        cfg = frame.FrameConfig(width=FULL[0], height=FULL[1], **presets.headline_capacities(draws.count))
        params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        for _ in range(frames):
            image, fb, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, mesh.InProcess())
        torch.cuda.synchronize()
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, "mesh dist: the ranks did not finish in 600 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    secs = time.perf_counter() - t0
    s = stats.to_dict()
    routes = []
    for rank in range(world):
        z = np.load(os.path.join(out, f"rank{rank}.npz"))
        routes.append(str(z["route"]))
        dv, vw = frame.state_to_numpy(states[rank])
        check(np.array_equal(z["image"], image.cpu().numpy()), f"mesh dist: rank {rank}'s image differs")
        check(np.array_equal(z["depth"], fb.depth.cpu().numpy()) and np.array_equal(z["vis"], fb.vis.cpu().numpy()),
              f"mesh dist: rank {rank}'s gdepth/gvis differ")
        check(np.array_equal(z["draw_vis"], dv) and np.array_equal(z["vis_words"], vw),
              f"mesh dist: rank {rank}'s state differs")
        check(all(np.array_equal(z[f"stats_{k}"], v) for k, v in s.items()), f"mesh dist: rank {rank}'s stats differ")
        log("mesh dist", f"rank {rank}: route {routes[-1]}; frame ms {z['frame_ms'].round(3).tolist()}")
    check(all(int(s[k]) == 0 for k in DROPS), "mesh dist: the steady frame dropped work")
    log("mesh dist", f"{world} gloo ranks on {dev}, one shard of {draws.count // world} draws each, {frames} frames, "
        f"{secs:.1f} s with the ranks' start-up: image, gdepth, gvis, stats and every rank's state equal the "
        f"in-process run bit for bit | {frame_line(s)} on {smi}")


def run_glass(kernels, geometry, draws, dev, smi, base) -> None:
    """The glass frame: cooker.glass_scene of the 1M draws (the alpha frame's
    scene with material 6's draws, 125,000, in the transmission class and
    materials 0-3 normal-mapped), post_passes=3, unshadowed, bloom on:
    first its 256x128 form against the CPU, then run_path at 1920x1080, the
    demand of each late group and the layer's covered and blended pixels,
    each kernel on the three passes and the layer against its plain
    version, and the profile.  The path's numbers ride in each kernel's row
    under "glass_path"."""
    import torch

    from niagara_tpu_torch import _build, cooker, scene
    from niagara_tpu_torch.ops import raster_tile, setup
    from niagara_tpu_torch.render import camera, frame, presets, textures

    g, d, mats, masks, mips = cooker.small_glass_scene(geometry)
    small_table = textures.build_texture_table(mips)
    small_reference("glass small", dev, scene.upload(g, d, mats, masks, texture_table=small_table), small_table,
                    frame.FrameConfig(width=256, height=128, post_passes=3, **presets.small_capacities()),
                    scene, camera, frame)

    t0 = time.perf_counter()
    g, d, mats, masks, mips = cooker.glass_scene(geometry, draws)
    table = textures.build_texture_table(mips)
    ds = scene.from_numpy(scene.upload(g, d, mats, masks, texture_table=table), dev)
    tex = textures.to_device(table, dev)
    torch.cuda.synchronize()
    log("glass scene", f"{ds.num_draws} draws: {int((d.post_pass == 1).sum())} alpha, {int((d.post_pass == 2).sum())} "
        f"transmission; {int((mats['textures'][:, 1] >= 0).sum())} of {len(mats['textures'])} materials normal-mapped "
        f"({mips[-1][0].shape[0]}^2), texel pool {table.texels.shape[0]}, {time.perf_counter() - t0:.1f} s")
    caps = presets.headline_capacities(ds.num_draws)
    cfg = frame.FrameConfig(width=FULL[0], height=FULL[1], post_passes=3, **caps)
    log("glass scene", f"capacities {caps}")
    expected = launch_counts(setup_alpha=9, raster=6, raster_alpha=3, shade=6, gbuffer=6, **bloom_launches(3),
                             **cull_launches(3, late_groups=2))
    path = run_path("glass ", ds, tex, cfg, dev, frame, camera, _build, expected, smi)
    s, steady = path["stats"], path["steady"]
    for name, st, (ts, *_), (tc, cap) in zip(steady["passes"], steady["setup_out"], steady["raster"],
                                             steady["setup"]):
        if name != "early":
            log("glass main", f"frame 4 {name} group: {int(tc['count'][0])} clusters of "
                f"{cfg.late_cluster_cap}, tris {int(st['count'])} of {cap}, pairs {int(ts[-1])} of "
                f"{cfg.late_pair_cap}")
    lay = steady["layer"]
    covered = int((lay["vis"] != INVALID).sum())
    blended = int((lay["valid"] & ((lay["depth"] > path["fb"].depth) | ~steady["valid"])).sum())
    log("glass main", f"frame 4: candidates {int(s['candidates'])} of {cfg.late_candidate_cap}; layer covers {covered} "
        f"px, blends {blended} px (in front of the opaque surface or over the background)")
    check(covered > 0 and blended > 0, "the transmission layer blends nothing")
    compare_kernels("glass ", "transitional frame 1", path["transitional"], ds, path["params"], cfg, setup,
                    raster_tile)
    rows = compare_kernels("glass ", "steady frame 4", path["steady"], ds, path["params"], cfg, setup, raster_tile,
                           base)
    for r in rows:
        kernels[r["name"]]["glass_path"] = side_row(r, path["launches"][r["name"]])
    compare_gbuffer("glass ", "transitional frame 1", path["transitional"], ds, tex, path["sp"])
    kernels["gbuffer"]["glass_path"] = side_row(compare_gbuffer("glass ", "steady frame 4", steady, ds, tex,
                                                                path["sp"]), path["launches"]["gbuffer"])
    profile_frames("glass profile", lambda st, i: frame.render_frame(ds, st, path["params"], path["sp"], cfg,
                                                                    textures=tex)[2], path["state"])


def run_configs(kernels, dev, smi) -> None:
    """The viewer (niagara_tpu_torch.render_scene) at 1920x1080 with
    --config 0, 1 and 2, two frames each, CONFIG_DRAWS torus draws, from a
    camera file that looks at the first draw: the launch counters at zero
    before each, read after; config 0 loss-free, configs 1 and 2 equal in
    depth; the PNGs written with the HUD; the camera file read back equal;
    config 0's last frame's kernels (the single-pass early pass) against
    their plain versions.  The numbers ride in each kernel's row under
    "configs_path".  Before that, the single-pass frame at 256x128 against
    the CPU."""
    import torch

    from niagara_tpu_torch import _build, cooker, render_scene, scene
    from niagara_tpu_torch.ops import raster_tile, setup
    from niagara_tpu_torch.render import camera, frame, presets

    geometry = cooker.cook_procedural()
    for config in (0, 1):
        small_reference(f"configs small {config}", dev,
                        scene.upload(geometry, cooker.small_scene_draws(geometry.meshes.count)), None,
                        frame.FrameConfig(width=256, height=128, **presets.small_capacities(),
                                          **presets.frame_overrides(config)),
                        scene, camera, frame, settings=presets.settings_for(config))

    out = os.path.join(ROOT, "chiprun_out", "viewer")
    cam_file = os.path.join(out, "view.camera.json")
    os.makedirs(out, exist_ok=True)
    at = cooker.synthesize_draws(geometry.meshes.count, draw_count=1).position[0] + np.float32([0, 0, CONFIG_VIEW])
    cam = camera.Camera(position=at)
    camera.save_camera(cam_file, cam)
    depth, per = {}, {}
    for config in (0, 1, 2):
        zero_launches()
        capture = {}
        t0 = time.perf_counter()
        r = render_scene.run(["--config", str(config), "--frames", "2", "--draws", str(CONFIG_DRAWS), "--size",
                              f"{FULL[0]}x{FULL[1]}", "--out", os.path.join(out, f"config{config}"), "--camera",
                              cam_file], capture=capture)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        s = r["stats"].to_dict()
        per[config] = (r, capture, launches)
        depth[config] = r["fb"].depth
        n = 1 if config < 2 else 2
        expected = launch_counts(setup=2 * n, raster=2 * n, shade=2, gbuffer=2,
                                 **bloom_launches(2), **cull_launches(2, two_pass=n == 2))
        log("configs", f"config {config}: {CONFIG_DRAWS} draws, frame ms (CUDA events) {r['frame_ms']}, "
            f"{secs:.1f} s with the PNGs | {frame_line(s)} covered_px {int((r['fb'].vis != INVALID).sum())} | passes "
            f"{capture['passes']} | launches {launches} (expected {expected}) on {smi}")
        check(launches == expected, f"config {config} kernel launch counts")
        check(all(os.path.getsize(p) > 0 for p in r["paths"]) and len(r["paths"]) == 2, "the viewer wrote no PNGs")
        check(bool(torch.isfinite(r["image"]).all()), f"config {config}: image not finite")
        if config == 0:
            check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), "config 0 dropped work")
            check(int(s["visible_draws"]) == CONFIG_DRAWS, "config 0 did not render every draw")
    # one draw more than the candidate budget holds: config 0 drops whole draws
    lod0, budget = int(geometry.meshes.lod_meshlet_count[0, 0]), r["cfg"].candidate_cap
    over = budget // lod0 + 1
    r = render_scene.run(["--config", "0", "--frames", "1", "--draws", str(over), "--size", f"{FULL[0]}x{FULL[1]}",
                          "--out", os.path.join(out, "config0_over"), "--camera", cam_file])
    s = r["stats"].to_dict()
    log("configs", f"config 0 holds {budget // lod0} draws ({lod0} LOD-0 clusters each, candidate budget {budget}); at "
        f"{over}: {frame_line(s)}")
    check(int(s["cmd_dropped"]) > 0, f"config 0 at {over} draws should drop draws past the candidate budget")
    loaded = camera.load_camera(cam_file)
    check(np.array_equal(loaded.position, cam.position) and np.array_equal(loaded.orientation, cam.orientation),
          "the camera file did not round-trip")
    check((depth[1] > 0).any() and torch.equal(depth[1], depth[2]), "configs 1 and 2 differ in depth")
    log("configs", f"config 0 loss-free; configs 1 and 2 equal in depth ({int((depth[1] > 0).sum())} px); camera file "
        f"{cam_file} round-trips; PNGs under {out}")
    r, capture, launches = per[0]
    rows = compare_kernels("configs ", "config 0 frame 2", capture, r["scene"], r["params"], r["cfg"], setup,
                           raster_tile)
    for row in rows:
        kernels[row["name"]]["configs_path"] = side_row(row, launches[row["name"]])


def to_first_frame(fn, *args, **kw):
    """(fn's result, seconds from the call to the end of its first
    render_frame, synchronized with the card)."""
    import torch

    from niagara_tpu_torch.render import frame

    render_frame, first = frame.render_frame, []

    def timed(*a, **k):
        out = render_frame(*a, **k)
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter())
        return out

    t0 = time.perf_counter()
    frame.render_frame = timed
    try:
        out = fn(*args, **kw)
    finally:
        frame.render_frame = render_frame
    return out, first[0] - t0


def run_obj_cache(dev, smi) -> None:
    """A user's .obj through the scene cache (cooker.cook_or_load) and the
    viewer: in a fresh directory under .cache/, the procedural torus's
    .obj cooked cold (a miss that writes the cache file) then warm (a hit
    that leaves it), the arrays equal byte for byte; after os.utime of the
    .obj the next call is a miss.  Then `python -m
    niagara_tpu_torch.render_scene x.obj` at its defaults (10,000 draws,
    1920x1080, 4 frames) on the card, its scene cache in .cache/ cold and
    then warm: the counters at zero before each run, every frame's kernels
    launched, the last frame loss-free and finite; frame ms (CUDA events)
    and the seconds to the first frame, cold against warm."""
    import shutil
    import tempfile

    import torch

    from niagara_tpu_torch import _build, cooker, render_scene
    from niagara_tpu_torch.cooker import cook

    os.makedirs(os.path.join(ROOT, ".cache"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="obj_cache_", dir=os.path.join(ROOT, ".cache"))
    try:
        t0 = time.perf_counter()
        obj = cooker.procedural_obj(work)
        t1 = time.perf_counter()
        cache = os.path.join(work, os.path.basename(obj) + ".cache.npz")

        def stamp():
            st = os.stat(cache)
            return st.st_ino, st.st_mtime_ns

        cold = cooker.cook_or_load([obj], cache_dir=work)
        t2 = time.perf_counter()
        written = stamp()
        warm = cooker.cook_or_load([obj], cache_dir=work)
        t3 = time.perf_counter()
        check(stamp() == written, "the warm call rewrote the cache file")
        a, b = cook._geometry_to_dict(cold), cook._geometry_to_dict(warm)
        check(set(a) == set(b) and all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a),
              "the cached geometry differs from the cooked one")
        st = os.stat(obj)
        os.utime(obj, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
        t4 = time.perf_counter()
        cooker.cook_or_load([obj], cache_dir=work)
        t5 = time.perf_counter()
        check(stamp() != written, "a touched .obj did not miss the cache")
        log("obj cache", f"{os.path.basename(obj)} written in {t1 - t0:.3f} s ({os.path.getsize(obj) / 1e6:.1f} MB); "
            f"cook_or_load cold (miss) {t2 - t1:.3f} s, warm (hit) {t3 - t2:.4f} s, arrays equal byte for byte "
            f"({len(a)} arrays, {os.path.getsize(cache) / 1e6:.1f} MB cache file); after os.utime a miss again "
            f"({t5 - t4:.3f} s) | on the host of {smi}")

        frames, (W, H) = 4, FULL
        expected = launch_counts(setup=2 * frames, raster=2 * frames, shade=frames, gbuffer=frames,
                                 **bloom_launches(frames, (W, H)), **cull_launches(frames))
        for label in ("cold", "warm"):
            zero_launches()
            t0 = time.perf_counter()
            r, first_s = to_first_frame(render_scene.run, [obj])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            s = r["stats"].to_dict()
            log("obj cache", f"viewer {label} scene cache: {r['scene'].num_draws} draws at {W}x{H}, first frame "
                f"after {first_s:.2f} s, frame ms (CUDA events) {[round(x, 3) for x in r['frame_ms']]}, {secs:.1f} s "
                f"with the PNGs | last frame {frame_line(s)} | launches {launches} (expected {expected}) on {smi}")
            check(r["scene"].num_draws == 10_000 and r["image"].shape == (H, W, 3), "the viewer's defaults changed")
            check(launches == expected, f"viewer {label}: kernel launch counts")
            check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), f"viewer {label} dropped work")
            check(bool(torch.isfinite(r["image"]).all()) and len(r["paths"]) == frames, f"viewer {label}: output")
            check(os.path.exists(os.path.join(render_scene.SCENE_CACHE, os.path.basename(obj) + ".cache.npz")),
                  "the viewer wrote no scene cache")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_entry(dev, smi) -> None:
    """The entry points (niagara_tpu_torch/entry.py): entry() on the card,
    two frames through its fn with the counters at zero (each frame's ms
    by CUDA events), against entry(device="cpu"): stats, state and vis
    equal, depth exact, the image within 2e-6 (small_reference's
    tolerances); then dryrun_multichip(4) on the card (4 shards in this
    process), its printed line checked, against the same dry run on the
    CPU the same way."""
    import contextlib
    import io

    import torch

    from niagara_tpu_torch import _build, entry
    from niagara_tpu_torch.render import frame

    kept = {}
    render_frame = frame.render_frame

    def keep(*a, **k):  # fn returns the image and state only; keep the rest
        out = render_frame(*a, **k)
        kept.setdefault(str(out[0].device), []).append(out)
        return out

    frame.render_frame = keep
    try:
        fn, (scene, state, params, sp) = entry.entry(device="cpu")
        for _ in range(2):
            _, state = fn(scene, state, params, sp)
        fn, (scene, state, params, sp) = entry.entry()
        zero_launches()
        times = []
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            _, state = fn(scene, state, params, sp)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        launches = dict(_build.LAUNCHES)
    finally:
        frame.render_frame = render_frame
    cfg = frame.FrameConfig(**entry.ENTRY_CONFIG)
    expected = launch_counts(setup=4, raster=4, shade=2, gbuffer=2, **bloom_launches(2, (cfg.width, cfg.height)),
                             **cull_launches(2))
    (ci, cfb, cst, cs), (gi, gfb, gst, gs) = kept["cpu"][-1], kept[str(dev)][-1]
    cs, gs = cs.to_dict(), gs.to_dict()
    image_err = float((ci - gi.cpu()).abs().max())
    log("entry", f"entry(): {cfg.width}x{cfg.height}, {scene.num_draws} draws, two frames from a cold state, frame ms "
        f"(CUDA events) {[round(t, 3) for t in times]} | frame 2 {frame_line(gs)} | against entry(device='cpu'): "
        f"stats/state/vis equal, depth max_abs_err {float((cfb.depth - gfb.depth.cpu()).abs().max()):.3g}, image "
        f"max_abs_err {image_err:.3g} (tolerances 0 / 2e-6) | launches {launches} (expected {expected}) on {smi}")
    check(launches == expected, "entry(): kernel launch counts")
    check(gi.shape == (cfg.height, cfg.width, 3) and bool(torch.isfinite(gi).all()), "entry(): image")
    check(all(np.array_equal(cs[k], gs[k]) for k in cs), "entry(): stats differ from the CPU")
    check(all(np.array_equal(a, b) for a, b in zip(frame.state_to_numpy(cst), frame.state_to_numpy(gst))),
          "entry(): state differs from the CPU")
    check(torch.equal(cfb.vis, gfb.vis.cpu()) and torch.equal(cfb.depth, gfb.depth.cpu()) and image_err <= 2e-6,
          "entry(): the frame differs from the CPU")

    n = MESH_SHARDS
    runs = {}
    for where in ("cpu", dev):
        if where != "cpu":
            zero_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = entry.dryrun_multichip(n, device=where)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if where != "cpu":
            launches = dict(_build.LAUNCHES)
        s = out["stats"]
        line = f"dryrun_multichip({n}): ok; visible_draws={int(s.visible_draws)} clusters={int(s.late_clusters)}\n"
        check(printed.getvalue() == line, f"dryrun_multichip({n}) printed {printed.getvalue()!r}")
        runs[str(where)] = (out, secs, printed.getvalue().strip())
    (c, _, _), (g, secs, line) = runs["cpu"], runs[str(dev)]
    expected = launch_counts(setup=2 * n, raster=n, raster_alpha=n, shade=n, gbuffer=n,
                             **bloom_launches(1, tuple(entry.DRYRUN_CONFIG[k] for k in ("width", "height"))),
                             **cull_launches(n))
    cs, gs = c["stats"].to_dict(), g["stats"].to_dict()
    image_err = float((c["image"] - g["image"].cpu()).abs().max())
    log("entry", f"{line} ({secs:.2f} s on the card, the cook a cache hit) | {frame_line(gs)} | against the CPU: "
        f"stats/states/gdepth/gvis equal, image max_abs_err {image_err:.3g} (tolerance 2e-6) | launches {launches} "
        f"(expected {expected}) on {smi}")
    check(launches == expected, f"dryrun_multichip({n}): kernel launch counts")
    check(all(np.array_equal(cs[k], gs[k]) for k in cs), "the dry run's stats differ from the CPU")
    check(all(np.array_equal(a, b) for x, y in zip(c["states"], g["states"])
              for a, b in zip(frame.state_to_numpy(x), frame.state_to_numpy(y))), "the dry run's states differ")
    check(torch.equal(c["fb"].vis, g["fb"].vis.cpu()) and torch.equal(c["fb"].depth, g["fb"].depth.cpu())
          and image_err <= 2e-6, "the dry run's frame differs from the CPU")


def side_row(r: dict, launches: int) -> dict:
    """A kernel's numbers on another path, kept inside its main row."""
    keys = ("ms", "baseline_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    return dict({k: r[k] for k in keys if k in r}, launches=launches)


def _timed(secs: dict, name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    secs[name] = round(time.perf_counter() - t0, 2)
    return out


def cook_city(out_dir: str, params: dict) -> dict:
    """Generate (or reuse) the city's .glb and DDS set and cook it cold
    into its scene cache (a cache from an earlier run on this disk is
    removed first).  Returns the seconds of each step."""
    from niagara_tpu_torch.cooker import gltf, synth_city

    secs = {}
    glb = _timed(secs, "generate", synth_city.ensure_city, out_dir, **params)
    for f in os.listdir(out_dir):
        if f.endswith(".scene.npz"):
            os.remove(os.path.join(out_dir, f))
    _timed(secs, "cook (cold)", gltf.load_scene, glb, cache_dir=out_dir)
    return secs


def prepare_city(out_dir: str, params: dict, cook_pool=None) -> dict:
    """The procedural city through the port's content path, on the host:
    `cook_city` (in `cook_pool`'s process when given, so that its Python
    does not hold this process's interpreter lock while the paths on the
    card run), then the scene from the cache the cold cook wrote, the
    textures decoded (none may fall back to magenta), the opacity masks
    baked, the texture table and the numpy device layout built.  Returns
    the SceneData, the table, the layout and the seconds of each step."""
    from niagara_tpu_torch import scene
    from niagara_tpu_torch.cooker import gltf, opacity
    from niagara_tpu_torch.render import textures

    secs = cook_pool.submit(cook_city, out_dir, params).result() if cook_pool else cook_city(out_dir, params)
    step = functools.partial(_timed, secs)
    sd = step("cook (cached)", gltf.load_scene, os.path.join(out_dir, "city.glb"), cache_dir=out_dir)
    mips, substituted = step("decode", textures.load_texture_mips, sd.texture_paths, base_dir=out_dir)
    check(not substituted, f"{len(substituted)} city textures failed to decode: {substituted[:5]}")
    masks = step("bake", opacity.bake_opacity, sd.geometry, sd.draws, sd.materials, mips)
    table = step("table", textures.build_texture_table, mips)
    np_scene = step("layout", scene.upload, sd.geometry, sd.draws, sd.materials, masks, texture_table=table)
    secs["done at"] = round(time.perf_counter() - STARTED, 1)
    return dict(sd=sd, table=table, scene=np_scene, seconds=secs)


def run_path(tag, ds, tex, cfg, dev, frame, camera, _build, expected, smi, cam=None, sun_direction=None) -> dict:
    """Two cold frames, then three steady ones with the launch counters at
    zero: each loss-free and finite, the counters as `expected`.  `cam` and
    `sun_direction` default to the headline frame's.  Returns the inputs
    kept from frames 1 and 4, the launches, frame 4's stats and
    framebuffer, the state after frame 4 and the frame inputs."""
    import torch

    params, sp = frame.make_frame_inputs(cam or camera.Camera(), camera.RenderSettings(), cfg,
                                         sun_direction=sun_direction)
    # from a cold state frame 0's early pass has nothing (no draw was visible
    # before) and its late pass takes the whole unoccluded set -- the camera-
    # cut case the late budgets are not sized for (reference frame.py:85-89:
    # drops for a frame, then heals); frame 1's early pass re-renders it
    state = frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev)
    transitional = {}
    for i in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, state, stats = frame.render_frame(ds, state, params, sp, cfg, textures=tex, capture=transitional)
        end.record()
        torch.cuda.synchronize()
        log(f"{tag}warmup", f"frame {i}: {start.elapsed_time(end):.3f} ms (capturing) | {frame_line(stats.to_dict())}")

    zero_launches()
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
    return dict(transitional=transitional, steady=steady, launches=launches, stats=s, state=state, params=params,
                sp=sp, fb=fb)


def small_reference(tag, dev, np_scene, table, cfg, scene, camera, frame, cam=None, sun_direction=None,
                    settings=None, bvh=None) -> None:
    """256x128, two frames: kernels on the card vs the plain path on the
    CPU, from `cam` (default: the headline camera) with `settings`
    (default RenderSettings()).  With a texture table (an alpha-classed
    scene) the masks must discard: with them cleared the same frame covers
    other pixels.  With post_passes=3 the transmission layer's depth and
    vis must match too.  With `bvh` (a host ShadowBVH; cfg.shadows) the
    frames are ray-traced: every traced flag must match, the shadow term
    within 2e-6, with shadow and light in it."""
    import dataclasses

    import torch

    from niagara_tpu_torch.render import textures

    params, sp = frame.make_frame_inputs(cam or camera.Camera(), settings or camera.RenderSettings(), cfg,
                                         sun_direction=sun_direction)
    runs = {}
    for where in ("cpu", dev):
        sc = scene.from_numpy(np_scene, where)
        tex = None if table is None else textures.to_device(table, where)
        st = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, where)
        cap = {}
        for _ in range(2):
            state_in = st
            img, fb, st, stats = frame.render_frame(sc, st, params, sp, cfg, textures=tex,
                                                    bvh=None if bvh is None else bvh.to(where), capture=cap)
        layer = cap["layer"] and (cap["layer"]["depth"].cpu(), cap["layer"]["vis"].cpu())
        rt = bvh and (cap["shadow"].cpu(), cap["trace"]["occluded"].cpu())
        runs[str(where)] = (img.cpu(), fb.depth.cpu(), fb.vis.cpu(), stats.to_dict(), frame.state_to_numpy(st), layer,
                            rt)
    (ci, cd, cv, cs, cst, cl, crt), (gi, gd, gv, gs, gst, gl, grt) = runs["cpu"], runs[str(dev)]
    check(all(np.array_equal(cs[k], gs[k]) for k in cs), "frame stats differ from the CPU plain path")
    check(all(np.array_equal(a, b) for a, b in zip(cst, gst)), "frame state differs from the CPU plain path")
    check(torch.equal(cv, gv), "vis differs from the CPU plain path")
    depth_err = float((cd - gd).abs().max())
    image_err = float((ci - gi).abs().max())
    extra = ""
    if cl:
        check(torch.equal(cl[1], gl[1]) and torch.equal(cl[0], gl[0]), "the transmission layer differs from the CPU")
        extra += f", transmission layer equal ({int((cl[1] != INVALID).sum())} px)"
    if table is not None:
        nomask = dataclasses.replace(sc, meshlet_alpha=torch.zeros_like(sc.meshlet_alpha))
        _, nfb, _, _ = frame.render_frame(nomask, state_in, params, sp, cfg, textures=tex)
        discarded = int(((nfb.vis != INVALID) & (nfb.vis != fb.vis)).sum())
        extra += f", masks discard {discarded} px (they win them with the masks cleared)"
        check(discarded > 0, "the opacity masks discard nothing")
    if crt:
        check(torch.equal(crt[1], grt[1]), "traced flags differ from the CPU plain path")
        term_err = float((crt[0] - grt[0]).abs().max())
        covered = cv != INVALID
        extra += (f", {crt[1].numel()} rays ({int(crt[1].sum())} occluded) equal, shadow term max_abs_err "
                  f"{term_err:.3g} (tolerance 2e-6), covered px in shadow (term < 0.5) "
                  f"{int((covered & (crt[0] < 0.5)).sum())}, lit (> 0.99) {int((covered & (crt[0] > 0.99)).sum())}")
        check(term_err <= 2e-6 and bool((covered & (crt[0] < 0.5)).any()) and bool((covered & (crt[0] > 0.99)).any()),
              "the small ray-traced frame's shadow term differs or has no shadow and light")
    # depth: every op rounded alike on both sides; image: the composite's
    # pow/exp (and the textures' sRGB decode) differ between the CPU's and
    # the GPU's math libraries (opaque: worst seen 9.24e-7 on an H100)
    log(tag, f"256x128 two frames, kernels on {dev} vs plain on cpu: stats/state/vis equal, "
        f"depth max_abs_err {depth_err:.3g}, image max_abs_err {image_err:.3g} (tolerances 0 / 2e-6), "
        f"covered px {int((cv != INVALID).sum())}, passes {cap['passes']}{extra}")
    check(depth_err == 0.0 and image_err <= 2e-6, "small frame differs from the CPU plain path")


def shade_work(streams, vis) -> tuple[float, float]:
    """(bytes, operations) of the attribute resolve: the visibility buffer,
    each winning record once (39 used floats), the attribute planes out;
    SHADE_OPS per covered pixel."""
    import torch

    covered = vis[vis != INVALID]
    winners = int(torch.unique(covered).numel())
    return vis.numel() * 4 + winners * 39 * 4 + vis.numel() * 13 * 4, SHADE_OPS * float(covered.numel())


def gbuffer_work(attrs, valid, sc, tex, depth=None, inverse_view_projection=None) -> tuple[float, float]:
    """(bytes, operations) of a G-buffer: the valid mask in and g0, g1 and
    valid out at every pixel; a valid pixel's attribute record, a 16-byte
    texel footprint for each slot it samples and, normal-mapped, its depth;
    GBUFFER_OPS per valid pixel, sample and bent normal."""
    nv = int(valid.sum())
    nbytes, ops = valid.numel() * (1 + 16 + 16 + 1) + nv * 13 * 4, GBUFFER_OPS["pixel"] * nv
    if tex is not None:
        mat = attrs[..., 7][valid].long()
        tids = (sc.mat_row[0].expand(nv, -1) if sc.mat_row.shape[0] == 1 else sc.mat_row[mat])[:, 11:15]
        nmap = depth is not None and inverse_view_projection is not None
        used = [on and (i != 1 or nmap) for i, on in enumerate(sc.texture_slots)]
        samples = sum(int((tids[:, i] > 0).sum()) for i in range(4) if used[i])
        bent = int((tids[:, 1] > 0).sum()) if used[1] else 0
        nbytes += samples * 16 + bent * 4
        ops += GBUFFER_OPS["sample"] * samples + GBUFFER_OPS["bend"] * bent
    return float(nbytes), float(ops)


def compare_gbuffer(tag, label, capture, ds, tex, sp) -> dict:
    """The frame's G-buffers (main, and the layer's) through the package's
    replay (render/parity.py replay_gbuffer: the kernel against
    gbuffer_plain, bit for bit), then each timed against the plain twin
    on the same inputs; times and bounds are per frame (both G-buffers).
    Returns the kernel's row."""
    from niagara_tpu_torch.ops import shade
    from niagara_tpu_torch.render import parity

    ms = plain_ms = nbytes = ops = 0.0
    for c in parity.replay_gbuffer(capture, ds, tex, sp.inverse_view_projection):
        for line in c["lines"]:
            log(f"{tag}kernels", f"{label} {line}")
        args, kw = c["args"], c["kwargs"]
        ms += cuda_ms(lambda: shade.gbuffer_cuda(*args, **kw), 20)
        plain_ms += cuda_ms(lambda: shade.gbuffer_plain(*args, **kw), 3)
        work = gbuffer_work(*args, **kw)
        nbytes += work[0]
        ops += work[1]
    bms, by = bound(nbytes, ops)
    log(f"{tag}kernels", f"{label} gbuffer: kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per frame, bound "
        f"{bms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop), share {bms / ms:.1%}, max_abs_err 0.0")
    return dict(name="gbuffer", route="cuda", source="niagara_tpu_torch/csrc/gbuffer.cu",
                replaces="none: XLA ops (niagara_tpu/ops/shade.py:260 gbuffer_from_attrs)", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


def compare_kernels(tag, label, capture, ds, params, cfg, setup, raster_tile, base=None) -> list[dict]:
    """Each kernel (and variant) of one captured frame against its plain
    version on the same inputs, through the package's replay
    (render/parity.py replay_frame: bit for bit, raster with a tie merge
    and, alpha_test, random masks); times and bounds are per frame (all
    passes).  With `base` (load_baseline's modules) its setup and raster
    wrappers are timed in turns with this tree's on the same inputs."""
    import torch

    from framebench.core import work
    from niagara_tpu_torch.render import parity

    W, H, tiles_x = cfg.width, cfg.height, cfg.width // 128
    rows = {}
    mods = dict(zip(("setup", "raster_tile"), (setup, raster_tile)))
    bases = dict(zip(("setup", "raster_tile"), base[1:])) if base else {}
    reps = dict(setup=(10, 3), raster_tile=(10, 2))
    for c in parity.replay_frame(capture, ds, params, cfg):
        for line in c["lines"]:
            log(f"{tag}kernels", f"{label} {line}")
        if c["module"] in ("cull", "pyramid"):
            for name, ms, plain_ms, nbytes in cull_timings(c):
                r = rows.setdefault(name, dict(ms=0.0, base_ms=None, plain_ms=0.0, bytes=0.0, ops=0.0))
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                r["bytes"] += nbytes
            continue
        name, mod, args, kw = c["name"], mods[c["module"]], c["args"], c["kwargs"]
        kernel, plain = getattr(mod, c["fn"]), getattr(mod, c["plain"])
        old = (lambda f=getattr(bases[c["module"]], c["fn"]): f(*args, **kw)) if base else None
        k_reps, p_reps = (20, 5) if name == "shade" else reps[c["module"]]
        ms, base_ms = in_turns(lambda: kernel(*args, **kw), old, k_reps)
        if name == "shade":
            counts = shade_work(*args)
        elif c["module"] == "setup":
            counts = work.setup_work(args[0], c["out"], name == "setup_alpha")
        else:
            counts = work.raster_work(args, name == "raster_alpha", H, W, tiles_x)
        r = rows.setdefault(name, dict(ms=0.0, base_ms=0.0 if base else None, plain_ms=0.0, bytes=0.0, ops=0.0))
        r["ms"] += ms
        if base:
            r["base_ms"] += base_ms
        r["plain_ms"] += cuda_ms(lambda: plain(*args, **kw), p_reps)
        r["bytes"] += counts[0]
        r["ops"] += counts[1]
        if base and c["module"] == "setup":  # what the zeroing of the whole capacity would cost before the launch
            cap, dev = args[5], args[0]["mi"].device
            zero_ms = cuda_ms(lambda: (torch.zeros((cap, 56), device=dev),
                                       torch.zeros((5, cap), dtype=torch.int32, device=dev)), 10)
            log(f"{tag}kernels", f"{label} {name} {c['pass_']}: zeroing the whole capacity ({cap} rows) alone takes "
                f"{zero_ms:.4f} ms")

    cull_src = "none: XLA ops (niagara_tpu/ops/cull.py draw_cull, cluster_cull_direct_multi; ops/raster.py " \
               "order_clusters_by_x, transform_meta_direct; ops/pyramid.py build_pyramid)"
    sources = dict(draw_cull=("cull.cu", cull_src), cluster_cull=("cull.cu", cull_src),
                   pyramid_base=("cull.cu", cull_src),
                   setup=("setup.cu", "niagara_tpu/ops/setup_fused.py:190"),
                   setup_alpha=("setup.cu", "niagara_tpu/ops/setup_fused.py:166"),
                   raster=("raster.cu", "niagara_tpu/ops/raster_tile.py:280"),
                   raster_alpha=("raster.cu", "niagara_tpu/ops/raster_tile.py:280"),
                   shade=("shade.cu", "niagara_tpu/ops/raster_tile.py:662"))
    out = []
    for name, r in rows.items():
        bms, by = bound(r["bytes"], r["ops"])
        was = f" (baseline {r['base_ms']:.4f} ms)" if r["base_ms"] else ""
        log(f"{tag}kernels", f"{label} {name}: kernel {r['ms']:.4f} ms{was} vs plain {r['plain_ms']:.4f} ms "
            f"per frame, bound {bms:.4f} ms by {by} ({r['bytes'] / 1e6:.1f} MB, {r['ops'] / 1e9:.2f} Gop), "
            f"share {bms / r['ms']:.1%}, max_abs_err 0.0")
        src, rep = sources[name]
        out.append(dict(name=name, route="cuda", source=f"niagara_tpu_torch/csrc/{src}", replaces=rep,
                        max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bms, bound_by=by,
                        library_ms=None, **({"baseline_ms": r["base_ms"]} if was else {})))
    return out


def cull_timings(c: dict) -> list:
    """A replayed cull pass or pyramid (render/parity.py replay_cull's
    record) timed against its plain twin on the same inputs: rows (name,
    kernel ms, plain ms, bytes the work needs).  A cull pass gives
    "draw_cull" (its draw stage: the zeroed scratch, the write-back's copy
    of the words and draw_cull_kernel) and "cluster_cull" (its cluster
    stage: cluster_cull_kernel, each group's sort and cluster_order_kernel);
    the pyramid gives "pyramid_base" (both of its kernels)."""
    from niagara_tpu_torch.ops import cull, pyramid

    if c["module"] == "pyramid":
        depth, levels, ph, pw = c["args"]
        return [("pyramid_base", cuda_ms(lambda: pyramid.pyramid_cuda(*c["args"]), 10),
                 cuda_ms(lambda: pyramid.build_pyramid_plain(*c["args"]), 3), 4 * (depth.numel() + levels * ph * pw))]
    sc, params = c["args"]
    kw, out = c["kwargs"], c["out"]
    dkw = {k: kw[k] for k in ("late", "pyramid_shape", "draw_capacity", "candidate_capacity", "num_classes")}
    ckw = {k: kw[k] for k in ("cluster_capacity", "class_groups")}
    dargs = (sc, params, kw["draw_vis"], kw["vis_words"], kw["atlas"])
    draw_ms = cuda_ms(lambda: cull.draw_cull_cuda(*dargs, **dkw), 10)
    drawn = iter([cull.draw_cull_cuda(*dargs, **dkw) for _ in range(11)])  # a cluster stage takes its own scratch
    cluster_ms = cuda_ms(lambda: cull.cluster_cull_cuda(sc, params, next(drawn), **ckw), 10)
    plain_drawn = cull.draw_stage_plain(*dargs, **dkw)
    plain_draw = cuda_ms(lambda: cull.draw_stage_plain(*dargs, **dkw), 3)
    plain_cluster = cuda_ms(lambda: cull.cull_clusters(sc, params, plain_drawn, **ckw), 3)
    # read once: a draw's mesh row, quaternion, scale, position, class,
    # visibility, offset and one LOD count and offset; written: emit, lod,
    # new_vis and a listed draw's entry; the write-back copies the words
    D, nl = sc.num_draws, sc.draw_lod_meshlet_count.shape[1]
    draw_bytes = D * (4 * (5 + nl) + 16 + 4 + 12 + 4 + 4 + 4 + 8 + 10) + int(out["n_draws"]) * 28
    if out["new_vis_words"] is not kw["vis_words"]:
        draw_bytes += 16 * kw["vis_words"].numel()
    # a candidate's entry, meshlet row, transform row and word; a group's
    # keys, draws and meshlets written, sorted, and its metadata gathered
    caps = [tc["mi"].shape[0] for tc in out["groups"]]
    cluster_bytes = int(out["n_candidates"]) * (24 + 32 + 32 + 8) + sum(cap * (12 + 8 + 4 + 60) for cap in caps)
    return [("draw_cull", draw_ms, plain_draw, draw_bytes), ("cluster_cull", cluster_ms, plain_cluster, cluster_bytes)]


def animate(sc, static_n: int, t: float):
    """The draws from static_n on moved as bench.py's animate_scene
    (niagara_tpu_torch/bench.py).  Returns (moved scene, its animated tail
    as a slice_draws view)."""
    from niagara_tpu_torch import bench

    moved = bench.animate_scene(sc, static_n, t)
    return moved, moved.slice_draws(static_n, sc.num_draws)


def sun_small(tag, dev, geometry, scene, camera, frame, presets, textures, sunmap, cooker) -> None:
    """The small alpha scene with a 256x256 sun map and an animated tail
    of its last three draws whose band is partial: two shadowed frames,
    kernels on the card vs the plain path on the CPU.  Maps, stats, state
    and vis equal; the image within 2e-6."""
    import torch

    from niagara_tpu_torch import bench

    g, d, mats, masks, mips = cooker.small_alpha_scene(geometry)
    table = textures.build_texture_table(mips)
    np_scene = scene.upload(g, d, mats, masks, texture_table=table)
    cfg = frame.FrameConfig(width=256, height=128, post_passes=2, shadows=True, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    m, static_n = 256, np_scene.num_draws - 3
    kw = dict(map_w=m, map_h=m, cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14,
              pair_capacity=1 << 15)
    runs = {}
    for where in ("cpu", dev):
        sc = scene.from_numpy(np_scene, where)
        tex = textures.to_device(table, where)
        sf = sunmap.fit_sun_to_draws(sp.sun_direction, d, device=where)
        static, drop = sunmap.build_static_sun_map(sc, sf, batch=16, num_draws=static_n, **kw)
        win = bench.tail_window(sf, sc.slice_draws(static_n, sc.num_draws), m, sunmap.map_texel_world(sf, m, m))
        a, b = win[0] * 8, (win[0] + win[1]) * 8
        packed_static = sunmap.pack_sun_map(static)
        st = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, where)
        maps, shadows = [static], []
        for i in range(2):
            moved, tail = animate(sc, static_n, 0.3 * (i + 1))
            band, udrop = sunmap.update_sun_map(tail, sf, static, None, row_window=win, **kw)
            drop = drop + udrop
            packed = sunmap.pack_band(packed_static, band, a, m, row_above=static[a - 1] if a else None,
                                      row_below=static[b] if b < m else None)
            cap = {}
            img, fb, st, stats = frame.render_frame(moved, st, params, sp, cfg, textures=tex, sun=(sf, packed, (m, m)),
                                                    capture=cap)
            maps += [band, packed]
            shadows.append(cap["shadow"])
        runs[str(where)] = dict(img=img.cpu(), depth=fb.depth.cpu(), vis=fb.vis.cpu(), stats=stats.to_dict(),
                                state=frame.state_to_numpy(st), maps=[x.cpu() for x in maps],
                                shadow=[x.cpu() for x in shadows], win=win, drop=int(drop))
    c, k = runs["cpu"], runs[str(dev)]
    check(c["win"] == k["win"] and 0 < c["win"][1] < m // 8, f"the tail's band {c['win']} must be partial")
    check(c["drop"] == k["drop"] == 0, "the small sun map dropped work")
    check(all(torch.equal(x, y) for x, y in zip(c["maps"], k["maps"])), "sun maps differ from the CPU plain path")
    check(all(np.array_equal(c["stats"][f], k["stats"][f]) for f in c["stats"]), "frame stats differ")
    check(all(np.array_equal(x, y) for x, y in zip(c["state"], k["state"])), "frame state differs")
    check(torch.equal(c["vis"], k["vis"]) and torch.equal(c["depth"], k["depth"]), "vis/depth differ")
    term_err = max(float((x - y).abs().max()) for x, y in zip(c["shadow"], k["shadow"]))
    image_err = float((c["img"] - k["img"]).abs().max())
    covered = c["vis"] != INVALID
    shaded = float(((c["shadow"][-1] < 1.0) & covered).sum() / covered.sum())
    log(tag, f"256x128 two animated frames, 256^2 sun map, tail band tile rows {c['win'][0]}.."
        f"{c['win'][0] + c['win'][1]} of {m // 8}: kernels on {dev} vs plain on cpu: maps, stats, state, vis, "
        f"depth equal; shadow term max_abs_err {term_err:.3g}, image max_abs_err {image_err:.3g} (tolerance "
        f"2e-6: exp2/pow differ between the CPU's and the GPU's math libraries); shadowed share of covered px "
        f"{shaded:.3f}; covered texels {int((c['maps'][0] > 0).sum())}")
    check(image_err <= 2e-6 and term_err <= 2e-6 and shaded > 0.0, "small shadowed frame differs or is unshadowed")


def run_sun(ds, draws, tex, cfg, dev, frame, camera, presets, sunmap, _build, smi) -> dict:
    """The benchmark's shadowed, animated frame: the static sun map of the
    first 98% of the draws (sun build), the tail's band and a forced band
    held to a full update (sun window), then two cold and three steady
    animated frames (sun warmup / sun main).  Returns the kept update
    inputs (steady frame 4, forced band), the launches, the state and the
    frame step."""
    import torch

    from niagara_tpu_torch import bench

    n = ds.num_draws
    anim_n = max(n // 50, 1)
    static_n = n - anim_n
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    sf = sunmap.fit_sun_to_draws(sp.sun_direction, draws, device=dev)
    texel = sunmap.map_texel_world(sf, SUN_MAP, SUN_MAP)
    # bench.py:165-173: the frame's budgets, triangles capped at 2^19 so the
    # (tile, tri) key of a 4,096-tile map fits in 32 bits
    sun_caps = dict(cmd_capacity=cfg.cmd_capacity, cluster_capacity=cfg.cluster_capacity,
                    tri_capacity=min(cfg.tri_capacity, 1 << 19), pair_capacity=cfg.pair_capacity)
    upd_caps = presets.sunmap_update_capacities(anim_n, sun_caps)
    kw = dict(map_w=SUN_MAP, map_h=SUN_MAP, texel_world=texel)

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static, drop = sunmap.build_static_sun_map(ds, sf, batch=SUN_BATCH, num_draws=static_n, **kw, **sun_caps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log("sun build", f"{-(-static_n // SUN_BATCH)} batches of {SUN_BATCH} draws over [0, {static_n}), "
        f"{SUN_MAP}^2 map, texel {texel:.5f} world units, budgets {sun_caps}: drops {int(drop)}, {secs:.3f} s, "
        f"covered texels {int((static > 0).sum())}, launches {dict(_build.LAUNCHES)} on {smi}")
    check(int(drop) == 0, "the static sun map dropped work")

    win = bench.tail_window(sf, ds.slice_draws(static_n, n), SUN_MAP, texel)
    a, b = win[0] * 8, (win[0] + win[1]) * 8
    row_above = static[a - 1] if a > 0 else None
    row_below = static[b] if b < SUN_MAP else None
    packed_static = sunmap.pack_sun_map(static)
    _, tail = animate(ds, static_n, 0.3)
    full, fdrop = sunmap.update_sun_map(tail, sf, static, None, **kw, **upd_caps)
    band, bdrop = sunmap.update_sun_map(tail, sf, static, None, row_window=win, **kw, **upd_caps)
    check(int(fdrop) == 0 and int(bdrop) == 0, "the tail's update dropped work")
    check(torch.equal(band, full[a:b]), "the bench band differs from the full update's rows")
    spliced = sunmap.pack_band(packed_static, band, a, SUN_MAP, row_above=row_above, row_below=row_below)
    check(torch.equal(spliced, sunmap.pack_sun_map(full)), "pack_band differs from a full repack")
    forced, forced_cap = (96, 32), {}
    fband, fbdrop = sunmap.update_sun_map(tail, sf, static, None, row_window=forced, capture=forced_cap, **kw,
                                          **upd_caps)
    check(torch.equal(fband, full[forced[0] * 8:(forced[0] + forced[1]) * 8]),
          "the forced band differs from the full update's rows")
    log("sun window", f"{anim_n} animated draws [{static_n}, {n}), update budgets {upd_caps}: bench window tile rows "
        f"{win[0]}..{win[0] + win[1]} of {SUN_MAP // 8} = (row0, n_rows) {win}; its band equals the full update's "
        f"rows and pack_band equals pack_sun_map of the full update, bit for bit; forced band {forced}: rows equal "
        f"bit for bit, {int(forced_cap['pairs'])} pairs in it, drops {int(fbdrop)} (drop_vec "
        f"{forced_cap['drop_vec'].tolist()}: the tail's pairs outside the band, reported)")

    def update(t, capture=None, stages=None):
        """Move the tail, update its band of the map, splice the band."""
        moved, tail_t = animate(ds, static_n, t)
        band_t, udrop = sunmap.update_sun_map(tail_t, sf, static, None, row_window=win, capture=capture,
                                              stages=stages, **kw, **upd_caps)
        return moved, sunmap.pack_band(packed_static, band_t, a, SUN_MAP, row_above=row_above, row_below=row_below), udrop

    def step(state, t, capture=None, upd_capture=None, events=None, stages=None):
        moved, packed_t, udrop = update(t, upd_capture, stages)
        if events:
            events[1].record()
        out = frame.render_frame(moved, state, params, sp, cfg, textures=tex, sun=(sf, packed_t, (SUN_MAP, SUN_MAP)),
                                 capture=capture, stages=stages)
        return out, udrop

    state = frame.init_state(n, ds.meshlet_visibility_count, dev)
    for i in range(2):
        (_, _, state, stats), udrop = step(state, 0.3 * (i + 1))
        log("sun warmup", f"frame {i}: {frame_line(stats.to_dict())} sun update drops {int(udrop)}")
    torch.cuda.synchronize()
    zero_launches()
    upd_ms, frame_ms = [], []
    for i in range(2, 5):
        cap, upd = {}, {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        (image, fb, state, stats), udrop = step(state, 0.3 * (i + 1), capture=cap, upd_capture=upd, events=ev)
        ev[2].record()
        torch.cuda.synchronize()
        upd_ms.append(ev[0].elapsed_time(ev[1]))
        frame_ms.append(ev[0].elapsed_time(ev[2]))
        s = stats.to_dict()
        covered = fb.vis != INVALID
        term = cap["shadow"][covered]
        shaded = float((term < 1.0).sum() / term.numel())
        log("sun main", f"frame {i}: update+splice {upd_ms[-1]:.3f} ms, animated frame {frame_ms[-1]:.3f} ms | "
            f"{frame_line(s)} covered_px {int(covered.sum())} shadowed share {shaded:.4f} (term < 0.5: "
            f"{float((term < 0.5).sum() / term.numel()):.4f}, mean term {float(term.mean()):.4f}) | sun update: "
            f"{int(upd['draws'])} commands, {int(upd['clusters'])} clusters, {int(upd['tris'])} tris, "
            f"{int(upd['pairs'])} pairs, drops {int(udrop)} {upd['drop_vec'].tolist()}")
        check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), f"frame {i} dropped work")
        check(int(udrop) == 0, f"frame {i}: the sun update dropped work")
        check(tuple(image.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(image).all()),
              "image not finite")
        check(shaded > 0.0, "no covered pixel is in shadow")
    launches = dict(_build.LAUNCHES)
    expected = launch_counts(setup_alpha=6, raster=3, raster_alpha=3, raster_alpha_window=3, shade=3, gbuffer=3,
                             **bloom_launches(3), **cull_launches(3))
    log("sun main", f"launches {launches} (expected {expected}); update+splice ms {upd_ms}, animated frame ms "
        f"{frame_ms} on {smi}")
    check(launches == expected, "kernel launch counts")
    sun_stages(step, state, dev, smi)
    return dict(update=upd, forced=forced_cap, launches=launches, state=state, step=step, update_step=update)


def sun_stages(step, state, dev, smi) -> None:
    """The animated frame from the steady state twice: without and with a
    StageTimer (utils/profiling.py) handed to the sun update and
    render_frame: image, depth, vis, state and stats bit for bit, the same
    launches; each column of the stage table sums to the frame's own ms
    (CUDA events and host clock around it) within 5%."""
    import torch

    from niagara_tpu_torch import _build
    from niagara_tpu_torch.utils.profiling import StageTimer, stage_table

    runs = []
    for timed in (False, True):
        zero_launches()
        timer, outer = StageTimer(dev), StageTimer(dev)
        outer.begin()
        if timed:
            timer.begin()
        (image, fb, new_state, stats), udrop = step(state, 0.3 * 6, stages=timer if timed else None)
        outer.mark("frame")
        whole = outer.resolve()[0]
        runs.append((image, fb, (new_state.draw_vis, new_state.vis_words), stats.to_dict(), int(udrop), dict(_build.LAUNCHES),
                     whole, timer.resolve() if timed else None))
    (i0, f0, st0, s0, u0, l0, _, _), (i1, f1, st1, s1, u1, l1, whole, frames) = runs
    check(torch.equal(i0.view(torch.int32), i1.view(torch.int32)) and torch.equal(f0.depth, f1.depth)
          and torch.equal(f0.vis, f1.vis), "the frame with a StageTimer differs from the frame without")
    check(all(torch.equal(x, y) for x, y in zip(st0, st1)) and all(np.array_equal(s0[k], s1[k]) for k in s0)
          and u0 == u1, "the state or stats with a StageTimer differ")
    check(l0 == l1, f"a StageTimer changed the launches: {l0} vs {l1}")
    table = stage_table(frames)
    dev_sum, host_sum = table["device_ms"], table["host_ms"]
    log("sun stages", f"the animated frame with and without a StageTimer: image, depth, vis, state, stats and launches "
        f"equal bit for bit; stages (device ms / host ms): "
        + ", ".join(f"{k} {v['device_ms']:.3f}/{v['host_ms']:.3f}" for k, v in table["stages"].items())
        + f"; sums {dev_sum:.3f}/{host_sum:.3f} against the frame's {whole['device_ms']:.3f}/{whole['host_ms']:.3f} "
        f"on {smi}")
    check(abs(dev_sum / whole["device_ms"] - 1) <= 0.05 and abs(host_sum / whole["host_ms"] - 1) <= 0.05,
          "the stage columns do not sum to the frame's ms")


def compare_window(tag, sun, raster_tile, base=None) -> dict:
    """The window variant, both instances, on the steady frame's band and on
    the forced band, each with a tie merge, against raster_plain through
    the package's replay (render/parity.py replay_band: bit for bit); time,
    plain time and bound of the path's instance on the steady band (and
    the baseline's time, in turns, when given)."""
    from framebench.core import work
    from niagara_tpu_torch.render import parity

    tiles_x = SUN_MAP // 128
    row = None
    for label, cap in (("steady frame 4 band", sun["update"]), ("forced band", sun["forced"])):
        row0 = cap["band_row0"]
        args = (*cap["raster"], tiles_x)
        for c in parity.replay_band(args, row0):
            for line in c["lines"]:
                log(tag, f"{label} {line}")
        if row is None:
            d0 = args[4]
            name = "raster_alpha_window"
            old = (lambda: base[2].raster_cuda(*args, alpha_test=True, band_row0=row0)) if base else None
            new = lambda: raster_tile.raster_cuda(*args, alpha_test=True, band_row0=row0)  # noqa: E731
            ms, base_ms = in_turns(new, old, 20)
            pms = cuda_ms(lambda: raster_tile.raster_plain(*args, alpha_test=True, band_row0=row0), 2)
            nbytes, ops = work.raster_work(args, True, d0.shape[0], SUN_MAP, tiles_x, row0, SUN_MAP)
            bms, by = bound(nbytes, ops)
            was = f" (baseline {base_ms:.4f} ms)" if base else ""
            log(tag, f"{label} {name}: kernel {ms:.4f} ms{was} vs plain {pms:.4f} ms per launch (1 launch per "
                f"frame), bound {bms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
            row = dict(name=name, route="cuda", source="niagara_tpu_torch/csrc/raster.cu",
                       replaces="niagara_tpu/ops/raster_tile.py:393", max_abs_err=0.0, ms=ms, plain_ms=pms,
                       bound_ms=bms, bound_by=by, library_ms=None, **({"baseline_ms": base_ms} if base else {}))
    return row


def run_rt(tag, ds, geometry, draws, tex, cfg, state, params, sp, dev, frame, shadow, _build, smi, per_frame,
           n_frames, mats=None, mips=None) -> dict:
    """The ray-traced frame (bench.py:363-390, BENCH_SHADOW): the BVH of
    the draws built on the host (build_scene_rt, then refit_tlas through
    its cached path, both timed as bench.py prints them), uploaded; then
    n_frames chained frames of render_frame(bvh=...) from `state` (with
    the alpha test when `mats` is given), the counters at zero: each
    loss-free and finite, shadow and light in the covered pixels, the
    launches `per_frame` times n_frames.  Returns the device BVH, the last
    frame's trace capture, the state, the launches and the frame times."""
    import dataclasses

    import torch

    t0 = time.perf_counter()
    host_bvh, static = shadow.build_scene_rt(geometry, draws, mats, mips)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_bvh = shadow.refit_tlas(static, draws)
    refit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = host_bvh.to(dev)
    torch.cuda.synchronize()
    nbytes = sum(getattr(bvh, f).numel() * 4 for f in shadow.TENSOR_FIELDS)
    log(f"{tag} scene", f"{draws.count} draws -> {bvh.inst_row.shape[0]} instances, {bvh.tlas_base} BLAS nodes, "
        f"{bvh.nodes.shape[0] - bvh.tlas_base} TLAS nodes, {bvh.tri_v0.shape[0]} triangles, mask rows "
        f"{bvh.tri_alpha.shape[0]}, {nbytes / 1e6:.1f} MB on the card | TLAS build {build_s:.3f} s (build_scene_rt), "
        f"refit {refit_s:.3f} s (refit_tlas, cached topology), upload {time.perf_counter() - t0:.3f} s")
    cfg = dataclasses.replace(cfg, shadows=True, shadow_quality=1 if mats is not None else 0)
    zero_launches()
    frame_ms, cap = [], {}
    for i in range(n_frames):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        image, fb, state, stats = frame.render_frame(ds, state, params, sp, cfg, textures=tex, bvh=bvh, capture=cap)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        s = stats.to_dict()
        covered = fb.vis != INVALID
        term = cap["shadow"][covered]
        tr = cap["trace"]
        log(f"{tag} main", f"frame {i}: {frame_ms[-1]:.3f} ms | {frame_line(s)} covered_px {int(covered.sum())} | "
            f"{tr['origin'].shape[0]} rays, {int(tr['occluded'].sum())} occluded; covered px in shadow (term < 0.5) "
            f"{float((term < 0.5).float().mean()):.4f}, lit (> 0.99) {float((term > 0.99).float().mean()):.4f}")
        check(all(int(s[k]) == 0 for k in DROPS) and not s["pair_drop_vec"].any(), f"frame {i} dropped work")
        check(tuple(image.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(image).all()),
              "image not finite")
        check(bool((term < 0.5).any()) and bool((term > 0.99).any()), "no shadow or no light in the covered pixels")
    launches = dict(_build.LAUNCHES)
    expected = {k: v * n_frames for k, v in per_frame.items()}
    log(f"{tag} main", f"launches {launches} (expected {expected}); frame ms {frame_ms} on {smi}")
    check(launches == expected, "kernel launch counts")
    return dict(bvh=bvh, trace=cap["trace"], state=state, launches=launches, cfg=cfg, frame_ms=frame_ms)


def simd_efficiency(walked, order=None) -> float:
    """The walk's SIMD efficiency in groups of 32 rays (a warp's): mean
    steps over the mean, across the groups, of each group's maximum, the
    rays grouped in id order or, given `order`, in its order (the last
    group padded with zero-step rays)."""
    import torch

    w = (walked if order is None else walked[order.long()]).float()
    pad = (-w.numel()) % 32
    groups = torch.cat([w, w.new_zeros(pad)]).view(-1, 32)
    return float(w.mean() / groups.max(dim=1).values.mean())


def steps_line(steps, occ, budget: int, order=None) -> str:
    """Rays, occluded share, steps per ray of one trace (steps -1: the
    budget ran out) and the walk's SIMD efficiency over 32-ray groups, in
    id order and, given the kernel's `order`, in that order."""
    cut = steps < 0
    walked = steps.clamp(min=0) + cut.to(steps.dtype) * budget
    eff = f"SIMD efficiency id order {simd_efficiency(walked):.4f}" + (
        f", ray order {simd_efficiency(walked, order):.4f}" if order is not None else "")
    return (f"{steps.numel()} rays, occluded {float(occ.float().mean()):.4f}, steps per ray mean "
            f"{float(walked.float().mean()):.2f} max {int(walked.max())}, out of budget ({budget}) "
            f"{int(cut.sum())} ({float(cut.float().mean()):.2e}), {eff}")


def compare_trace(tag, label, bvh, trace, shadow, base=None) -> dict:
    """A frame's trace replayed through the package's replay
    (render/parity.py replay_trace): the kernel (trace_any_hit<alpha_test>,
    the rays in the frame's order) against the frame's flags and
    trace_plain on the same card tensors, on the card's grid and on one
    block, every flag and step count equal; the kernel's time behind the
    spin kernel (with `base`, in turns with the baseline tree's trace_cuda
    on the same rays, which takes them in id order), the plain loop's
    time, and the bound.  Bytes: each distinct node (32 B), triangle
    (48 B), instance (48 B) and mask + uv row (64 B) the walk touches read
    once, each ray's origin and direction read and its flag and step count
    written (29 B); the rows every ray fetches, counted per ray, give a
    second, looser figure.  Operations: TRACE_OPS per node step, triangle
    test, instance entry and mask test, counted per ray by trace_plain."""
    from niagara_tpu_torch.render import parity

    o, d, alpha, budget, order = (trace[k] for k in ("origin", "direction", "alpha_test", "max_steps", "order"))
    rep = parity.replay_trace(bvh, trace, counters=True)
    name, p_occ, p_steps, counts, counted_s = rep["name"], rep["occluded"], rep["steps"], rep["counts"], rep["plain_s"]
    n = o.shape[0]
    per_ray = {k: float(counts[k].double().sum()) for k in TRACE_OPS}
    rows = {"nodes": "node_rows", "tris": "tri_rows", "instances": "inst_rows", "masks": "mask_rows"}
    distinct = {k: int(counts[rows[k]].sum()) for k in TRACE_OPS}
    nbytes = sum(distinct[k] * TRACE_ROW_BYTES[k] for k in TRACE_OPS) + n * TRACE_RAY_BYTES
    fetched = sum(per_ray[k] * TRACE_ROW_BYTES[k] for k in TRACE_OPS) + n * TRACE_RAY_BYTES
    ops = sum(per_ray[k] * TRACE_OPS[k] for k in TRACE_OPS)
    bms, by = bound(nbytes, ops)
    fetched_ms = bound(fetched, ops)[0]
    old = (lambda: base[3].trace_cuda(bvh, o, d, max_steps=budget, alpha_test=alpha)) if base else None
    ms, base_ms = in_turns(lambda: shadow.trace_cuda(bvh, o, d, max_steps=budget, alpha_test=alpha, order=order),
                           old, 10)
    plain_ms = cuda_ms(lambda: shadow.trace_plain(bvh, o, d, max_steps=budget, alpha_test=alpha), 1)
    walked = p_steps.clamp(min=0) + (p_steps < 0).to(p_steps.dtype) * budget
    log(tag, f"{label} {name}: {steps_line(p_steps, p_occ, budget, order)}; kernel flags and step counts equal "
        f"trace_plain's on the card's grid and on one block (max_abs_err 0.0); per ray "
        f"{', '.join(f'{k} {per_ray[k] / n:.2f}' for k in TRACE_OPS)}; distinct rows {distinct}")
    log(tag, f"{label} {name}: kernel {ms:.4f} ms"
        + (f" vs the baseline's {base_ms:.4f} ms in turns ({base_ms / ms:.2f}x)" if base else "")
        + f" vs plain {plain_ms:.1f} ms (with counters {counted_s * 1e3:.1f} ms), bound {bms:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB read once, {ops / 1e9:.3f} Gop), share {bms / ms:.1%}; the rows each ray fetches: "
        f"{fetched / 1e6:.1f} MB, {fetched_ms:.4f} ms, share {fetched_ms / ms:.1%}")
    return dict(name=name, route="cuda", source="niagara_tpu_torch/csrc/trace.cu",
                replaces="niagara_tpu/ops/shadow.py:320", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, fetched_bound_ms=fetched_ms, rays=n,
                steps_mean=float(walked.double().mean()), steps_max=int(walked.max()),
                out_of_budget=float((p_steps < 0).double().mean()), simd_id=simd_efficiency(walked),
                simd_order=simd_efficiency(walked, order) if order is not None else None,
                **({"baseline_ms": base_ms} if base else {}))


def level_chain(bm, mip0, levels: int):
    """The bloom chain from mips[0] a level a launch: bloom_down for each
    level, then bloom_up back up (bm: an ops.bloom module)."""
    mips = [mip0]
    for _ in range(1, levels):
        mips.append(bm.down2_cuda(mips[-1]))
    acc = mips[-1]
    for mip in mips[-2::-1]:
        acc = bm.up2_add_cuda(acc, mip)
    return acc


def compare_bloom(tag, g0, width: int, height: int, bloom, base=None) -> list[dict]:
    """bloom.cu's kernels on a frame's g0 with its emissive channel replaced
    by seeded nonzero values, through the package's replay
    (render/parity.py replay_bloom): the frame's calls (bloom_down, the
    tail with its every level, bloom_up, bloom_x2) against their plain
    versions on the same inputs, bit for bit, then the whole chain and the
    expansion; here each launch's time alone (with `base`, the baseline
    tree's kernels on the same input in turns), the per-frame times,
    bounds and the library yardsticks; the down and up chain as the frame
    runs it beside the chain a level a launch (the baseline tree's, in
    turns, or this tree's); one bloom a frame under the profiler."""
    import torch
    import torch.nn.functional as F

    from niagara_tpu_torch.render import parity

    rep = parity.replay_bloom(g0, width, height)
    g0, mips, levels, start, full = rep["g0"], rep["mips"], rep["levels"], rep["start"], rep["full"]
    rows = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, library_err=0.0, base_ms=0.0)
            for k in BLOOM_REPLACES}
    base_bloom = base[4] if base else None

    # the library yardsticks compute the same functions in full f32 (no
    # TF32) from the same level, the edge padding (F.pad replicate) timed
    # with them: conv2d (6x6, stride 2) down, conv_transpose2d (8x8, stride
    # 2) plus the accumulate up, bilinear interpolate x2; the tail's is
    # those of the levels it replaces, one after another
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        wdown = torch.tensor(bloom._DOWN_K, dtype=torch.float32, device=g0.device).expand(3, 1, 6, 6).contiguous()
        wup = torch.zeros((8, 8), dtype=torch.float64)
        for (py, px), k in bloom._UP_K.items():
            for j in range(4):
                for i in range(4):
                    wup[7 - py - 2 * j, 7 - px - 2 * i] = float(k[py + j, px + i])
        wup = wup.to(torch.float32).to(g0.device).expand(3, 1, 8, 8).contiguous()

        def lib_down(src):
            _, h, w = src.shape
            oh, ow = (h + 1) // 2, (w + 1) // 2
            return F.conv2d(F.pad(src[None], (2, 2 * ow - w + 4, 2, 2 * oh - h + 4), mode="replicate"), wdown,
                            stride=2, groups=3)[0, :, :oh, :ow]

        def lib_up(src, mip):
            _, oh, ow = mip.shape
            return mip + F.conv_transpose2d(F.pad(src[None], (2, 2, 2, 2), mode="replicate"), wup, stride=2,
                                            groups=3)[0, :, 7:7 + oh, 7:7 + ow]

        def lib_tail(src, n):
            ms = [src]
            for _ in range(1, n):
                ms.append(lib_down(ms[-1]))
            acc = ms[-1]
            for mip in ms[-2::-1]:
                acc = lib_up(acc, mip)
            return acc

        for c in rep["calls"]:
            name, src, p = c["name"], c["src"], c["out"]
            if name == "bloom_down":
                library, old = (lambda s=src: lib_down(s)), (lambda s=src: base_bloom.down2_cuda(s))
                nbytes, ops = src.numel() * 4 + p.numel() * 4, BLOOM_OPS[name] * p.numel()
            elif name == "bloom_up":
                mip = c["mip"]
                library, old = (lambda s=src, m=mip: lib_up(s, m)), (lambda s=src, m=mip: base_bloom.up2_add_cuda(s, m))
                nbytes, ops = src.numel() * 4 + 2 * mip.numel() * 4, BLOOM_OPS[name] * mip.numel()
            elif name == "bloom_tail":
                n = c["n"]
                library, old = (lambda s=src, n=n: lib_tail(s, n)), (lambda s=src, n=n: level_chain(base_bloom, s, n))
                p = p[-1]
                nbytes = src.numel() * 4 + sum(x.numel() * 4 for x in c["out"])
                ops = sum(BLOOM_OPS["bloom_down" if i < n - 1 else "bloom_up"] * x.numel()
                          for i, x in enumerate(c["out"]))
            else:
                library = lambda s=src: F.interpolate(s[None], size=(height, width), mode="bilinear",  # noqa: E731
                                                      align_corners=False)[0].permute(1, 2, 0)
                old = lambda s=src: base_bloom.bilinear_x2_cuda(s, height, width)  # noqa: E731
                nbytes, ops = src.numel() * 4 + 3 * height * width * 4, BLOOM_OPS[name] * 3 * height * width
            c["ms"], c["base_ms"] = in_turns(c["kernel"], old if base else None, 20)
            r = rows[name]
            err = float((library().reshape(p.shape) - p).abs().max() / p.abs().max())
            r["library_err"] = max(r["library_err"], err)
            r["ms"] += c["ms"]
            r["base_ms"] += c["base_ms"] or 0.0
            r["plain_ms"] += cuda_ms(c["plain"], 5)
            r["library_ms"] += cuda_ms(library, 20)
            r["bytes"] += nbytes
            r["ops"] += ops
    finally:
        torch.backends.cudnn.allow_tf32 = prev

    log(tag, f"g0 {tuple(g0.shape)} with seeded emissive, {levels} levels "
        f"{[tuple(m.shape[1:]) for m in mips]}, the tail from mip {start}: bloom_down, every level the tail writes, "
        f"bloom_up and bloom_x2 equal their plain versions bit for bit, compute_bloom and sample_bloom_fullres equal "
        f"the plain chain bit for bit (max_abs_err 0); bloom mean {float(full.mean()):.4g}")
    for c in rep["calls"]:
        log(tag, f"{c['name']} on {tuple(c['src'].shape)}{' (' + str(c['n']) + ' levels)' if 'n' in c else ''}: "
            f"{c['ms']:.4f} ms a launch, alone (20 back to back)"
            + (f", the baseline's {c['base_ms']:.4f} ms in turns" if base else ""))
    # the chain's bound counts every level's bytes and operations as a level
    # a launch would (the tail reads its intermediate levels on chip)
    chain_bytes = chain_ops = 0.0
    for big, small in zip(mips, mips[1:]):
        chain_bytes += (big.numel() + small.numel()) * 4 + (small.numel() + 2 * big.numel()) * 4
        chain_ops += BLOOM_OPS["bloom_down"] * small.numel() + BLOOM_OPS["bloom_up"] * big.numel()

    # the down and up chain as the frame runs it, from mips[0] (the extract
    # excluded): the large levels, the tail; beside it the chain a level a
    # launch (the baseline tree's kernels in turns, or this tree's
    # large-level kernels at every level)
    chain = lambda: bloom.cuda_chain(mips[0], levels)  # noqa: E731
    check(torch.equal(chain().view(torch.int32), rep["half"].view(torch.int32)),
          "cuda_chain differs from compute_bloom")
    times = chain_times(chain, lambda: level_chain(base_bloom or bloom, mips[0], levels))
    cbms, cby = bound(chain_bytes, chain_ops)
    launches = bloom_launches(1, (width, height))
    log(tag, f"the down and up chain ({launches['bloom_down']} + {launches['bloom_tail']} + {launches['bloom_up']} "
        f"launches): {times['ms']:.4f} ms on the device (20 chains behind the spin), {times['ms_100']:.4f} ms a chain "
        f"100 back to back, {times['host_ms']:.4f} ms of host enqueue; a level a launch "
        f"({'the baseline' if base else 'this tree'}'s bloom_down/bloom_up, {2 * (levels - 1)} launches, in turns): "
        f"{times['old_ms']:.4f} ms, {times['old_ms_100']:.4f} ms, {times['old_host_ms']:.4f} ms host; bound "
        f"{cbms:.5f} ms by {cby} ({chain_bytes / 1e6:.2f} MB, every level's bytes), share {cbms / times['ms']:.1%}")

    # one bloom (chain + expansion) under the profiler: its launches, device
    # time, and that only bloom.cu's kernels and the extract's ops run.  The
    # profiler on the card has lost a share of a window's device events (in
    # one run 37% of them, torch's kernels and bloom.cu's alike, where a
    # fresh process on the same image reported all of them): a window short
    # of the expected launches is taken again, at most three times
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expected = 5 * sum(launches.values())
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                bloom.sample_bloom_fullres(bloom.compute_bloom(g0, width, height), width, height)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ours = [e for e in device if "bloom_" in e.name]
        log(tag, f"one bloom a frame (profiler, 5 calls, window {attempt + 1}): {len(device) / 5:.0f} device ops of "
            f"which {len(ours) / 5:.0f} bloom.cu launches, {sum(e.time_range.elapsed_us() for e in device) / 5e3:.4f} "
            f"ms device time ({sum(e.time_range.elapsed_us() for e in ours) / 5e3:.4f} ms in bloom.cu); the rest is "
            f"the plain extract")
        if len(ours) == expected:
            break
    check(len(ours) == expected, f"the bloom chain did not run on bloom.cu's {expected // 5} launches a frame")

    out = []
    for name, r in rows.items():
        check(r["library_err"] < 1e-5, f"{name}: the library yardstick computes another function")
        bms, by = bound(r["bytes"], r["ops"])
        log(tag, f"{name}: kernel {r['ms']:.4f} ms"
            + (f" (the baseline's {r['base_ms']:.4f} ms in turns)" if base else "")
            + f" vs plain {r['plain_ms']:.4f} ms vs library {r['library_ms']:.4f} ms "
            f"(relative difference {r['library_err']:.2g}) per frame, {launches[name]} launches, bound {bms:.5f} ms by "
            f"{by} ({r['bytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} Mop), share {bms / max(r['ms'], 1e-9):.1%}, "
            f"max_abs_err 0.0")
        row = dict(name=name, route="cuda", source="niagara_tpu_torch/csrc/bloom.cu", replaces=BLOOM_REPLACES[name],
                   max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bms, bound_by=by,
                   library_ms=r["library_ms"], **({"baseline_ms": r["base_ms"]} if base else {}))
        if name == "bloom_tail":
            row["chain"] = dict(times, level_a_launch=("baseline" if base else "this tree"), bound_ms=cbms,
                                start=start, launches=launches)
        out.append(row)
    return out


def profile_frames(tag, step, state, n: int = 5, smi: str = "") -> None:
    """torch.profiler over n chained frames, `step(state, i)` rendering
    frame i and returning the next state: device ops and kernel launches
    per frame, device busy time (union of device op intervals) and idle
    share of the host wall time, and the costliest device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state = step(state, i)
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
        f"{busy / 1e3 / n:.3f} ms/frame, device idle share {1 - busy / wall_us:.3f}{' on ' + smi if smi else ''}")
    blooms = {k: v for k, v in by_name.items() if "bloom_" in k}
    n_bloom = sum(1 for e in device if "bloom_" in e.name)
    log(tag, f"bloom.cu: {n_bloom / n:.0f} launches/frame, {sum(blooms.values()) / 1e3 / n:.4f} ms/frame device")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(tag, f"{us / 1e3 / n:9.4f} ms/frame  {name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
