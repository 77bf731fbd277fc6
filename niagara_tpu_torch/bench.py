"""The port's benchmark: `python3 -m niagara_tpu_torch.bench`.

bench.py's frames, step for step, on the PyTorch/CUDA port (bench.py is
the JAX reference's, which needs JAX and kitten.obj): the procedural
torus (cooker.cook_procedural, the kitten's stand-in, through the scene
cache as bench.py:69 cooks the kitten) instanced
BENCH_DRAWS times by the reference's PCG scatter, rendered at 1920x1080
as the full frame: two-pass occlusion culling, the alpha-tested late
pass, textured deferred shading, sun-map shadows over an animated tail,
bloom and the composite.

Runs on the first card (`--device cuda`, the default) and exits nonzero
without one; `--device cpu` runs the plain torch versions on the host.

Knobs (environment; bench.py's names and defaults):
  BENCH_DRAWS 1000000, BENCH_W 1920, BENCH_H 1080, BENCH_FRAMES 5 (chained
  frames per timing); BENCH_TEXTURES 1 (the synthetic checker materials),
  BENCH_ALPHA 1 (1/8 of the draws in the alpha class, opacity masks),
  BENCH_SUNMAP 1 (the static sun map), BENCH_MAP 2048 (its size),
  BENCH_ANIMATE 1 (the last 2% of the draws move each frame: tail update,
  splice, animated frame); BENCH_PARITY 1 (render/parity.py's
  kernel-vs-plain gate before any timing); BENCH_SHADOW 0 (ray-traced
  shadows: BVH build and refit, shadow_pass, RT frames); BENCH_GLTF 1 (the
  procedural glTF city under .cache/city/); BENCH_GLASS 0 (the glass
  frame, post_passes=3); BENCH_SHARDS 0 (the sharded frame in N shards
  on the card); BENCH_STAGES 0 (per-stage device and host ms of more
  frames); BENCH_PROBE 1 (nvidia-smi and the device-to-device copy rate);
  BENCH_CMD_CAP, BENCH_CLUSTER_CAP, BENCH_CANDIDATE_CAP,
  BENCH_LATE_CANDIDATE_CAP, BENCH_TRI_CAP, BENCH_PAIR_CAP,
  BENCH_LATE_CLUSTER_CAP, BENCH_LATE_TRI_CAP, BENCH_LATE_PAIR_CAP override
  presets.headline_capacities.

Frame times are CUDA events at each frame's boundaries of a chained run
(no synchronization inside it; the host clock on the CPU).  Prints one
JSON line on stdout; everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build, cooker, scene as scene_mod
from .ops import shadow as shadow_ops, sunmap
from .render import camera, frame, presets, textures
from .utils.profiling import StageTimer, stage_marker, stage_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CITY_DIR = os.path.join(ROOT, ".cache", "city")
KNOBS = dict(DRAWS=1_000_000, W=1920, H=1080, FRAMES=5, TEXTURES=1, SUNMAP=1, ALPHA=1, MAP=2048, ANIMATE=1,
             SHADOW=0, GLTF=1, GLASS=0, SHARDS=0, STAGES=0, PARITY=1, PROBE=1)
ENV_CAPS = dict(cmd_capacity="BENCH_CMD_CAP", cluster_capacity="BENCH_CLUSTER_CAP",
                candidate_capacity="BENCH_CANDIDATE_CAP", late_candidate_capacity="BENCH_LATE_CANDIDATE_CAP",
                tri_capacity="BENCH_TRI_CAP", pair_capacity="BENCH_PAIR_CAP",
                late_cluster_capacity="BENCH_LATE_CLUSTER_CAP", late_tri_capacity="BENCH_LATE_TRI_CAP",
                late_pair_capacity="BENCH_LATE_PAIR_CAP")
DROPS = ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped")
# the sun map's static build (bench.py:169-176): the frame's budgets, with
# triangles capped at 2^19 so a 4,096-tile map's (tile, tri) key fits in u32
SUN_TRI_CAP = 1 << 19
PROBE_BYTES = 1 << 30


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def knobs() -> dict:
    return {k: int(os.environ.get(f"BENCH_{k}", v)) for k, v in KNOBS.items()}


def capacities(draw_count: int) -> dict:
    """presets.headline_capacities with the BENCH_*_CAP overrides."""
    caps = presets.headline_capacities(draw_count)
    caps.update({k: int(os.environ[env]) for k, env in ENV_CAPS.items() if env in os.environ})
    return caps


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chained(dev, n: int, step, carry):
    """carry = step(i, carry) for i in range(n), chained with no
    synchronization inside: a CUDA event (the host clock on the CPU) at
    each frame's boundaries, one wait at the end.  Returns (each frame's
    ms, the loop's wall seconds, the last carry)."""
    timer = StageTimer(dev)
    t0 = time.perf_counter()
    for i in range(n):
        timer.begin()
        carry = step(i, carry)
        timer.mark("frame")
    frames = timer.resolve()
    return [f["device_ms"] for f in frames], time.perf_counter() - t0, carry


def staged(dev, n: int, step, carry):
    """`chained` with a StageTimer handed to each step (`step(i, carry,
    stages)`) inside an outer frame boundary: per-stage device and host
    ms, and per frame how far each column's sum is from the frame's own
    ms (outer events and host clock).  Returns (table, carry)."""
    timer, outer = StageTimer(dev), StageTimer(dev)
    for i in range(n):
        outer.begin()
        timer.begin()
        carry = step(i, carry, timer)
        outer.mark("frame")
    frames, whole = timer.resolve(), outer.resolve()
    table = stage_table(frames)
    table["frame_device_ms"] = [w["device_ms"] for w in whole]
    table["frame_host_ms"] = [w["host_ms"] for w in whole]
    table["device_sum_ms"] = [sum(r[1] for r in f["stages"]) for f in frames]
    table["host_sum_ms"] = [sum(r[2] for r in f["stages"]) for f in frames]
    table["reconcile"] = max(max(abs(s / w - 1) for s, w in zip(table[f"{c}_sum_ms"], table[f"frame_{c}_ms"]))
                             for c in ("device", "host"))
    return table, carry


def print_stages(title: str, table: dict) -> None:
    log(f"stages of {title} (mean over {len(table['frame_device_ms'])} frames; device = the device timeline "
        f"between boundary events, the device's idle wait for the host's launches included; host = the host's "
        f"enqueue time):")
    log(f"  {'stage':28s} {'device ms':>10s} {'host ms':>10s}")
    for name, r in table["stages"].items():
        log(f"  {name:28s} {r['device_ms']:10.3f} {r['host_ms']:10.3f}")
    log(f"  {'sum':28s} {table['device_ms']:10.3f} {table['host_ms']:10.3f}")
    log(f"  per frame, device sums {[round(x, 3) for x in table['device_sum_ms']]} vs frame "
        f"{[round(x, 3) for x in table['frame_device_ms']]}; host sums "
        f"{[round(x, 3) for x in table['host_sum_ms']]} vs frame {[round(x, 3) for x in table['frame_host_ms']]}; "
        f"largest relative gap {table['reconcile']:.2e}")


def drops(stats) -> dict:
    s = stats.to_dict()
    return dict({k.removesuffix("_dropped"): int(s[k]) for k in DROPS}, pair_vec=s["pair_drop_vec"].tolist())


def lossless(d: dict) -> bool:
    return all(not any(v) if isinstance(v, list) else v == 0 for v in d.values())


def sun_delta(t: float, dev):
    """bench.py's tail motion at time t: 2 (sin t, 0, 1 - cos t), f32."""
    t = np.float32(t)
    return torch.tensor(np.array([np.sin(t), 0.0, 1.0 - np.cos(t)], np.float32) * np.float32(2.0), device=dev)


def animate_tail(sc, t: float):
    """Every draw of `sc` (the animated tail, slice_draws) moved by
    sun_delta(t) (bench.py:184-193)."""
    d = sun_delta(t, sc.draw_position.device)
    xf = sc.draw_xform_row.clone()
    xf[:, 0:3] += d
    return dataclasses.replace(sc, draw_position=sc.draw_position + d, draw_xform_row=xf)


def animate_scene(sc, static_n: int, t: float):
    """The draws from static_n on moved by sun_delta(t) (bench.py:325-332)."""
    d = sun_delta(t, sc.draw_position.device)
    pos, xf = sc.draw_position.clone(), sc.draw_xform_row.clone()
    pos[static_n:] += d
    xf[static_n:, 0:3] += d
    return dataclasses.replace(sc, draw_position=pos, draw_xform_row=xf)


@dataclasses.dataclass
class SunTail:
    """The static sun map and the animated tail's band update
    (bench.py:153-268): `update(t)` moves the tail, renders its band of
    the map and splices the band into the cached pack table."""

    sf: dict
    static: torch.Tensor
    packed_static: torch.Tensor
    tail: object
    window: tuple
    caps: dict
    map_wh: int
    texel: float

    def update(self, t: float, stages=None):
        """(packed table, the update's drops); `stages` gets the
        boundaries "tail move", the band's "sun cull", "sun setup", "sun
        raster" (ops/sunmap.render_sun_map) and "pack_band"."""
        mark = stage_marker(stages)
        m, (row0, rows) = self.map_wh, self.window
        a, b = row0 * 8, (row0 + rows) * 8
        tail_t = animate_tail(self.tail, t)
        mark("tail move")
        band, drop = sunmap.update_sun_map(tail_t, self.sf, self.static, None, map_w=m, map_h=m,
                                           texel_world=self.texel, row_window=self.window, stages=stages, **self.caps)
        packed = sunmap.pack_band(self.packed_static, band, a, m, row_above=self.static[a - 1] if a > 0 else None,
                                  row_below=self.static[b] if b < m else None)
        mark("pack_band")
        return packed, drop


def tail_window(sf, tail, map_wh: int, texel: float) -> tuple:
    """The animated tail's dirty band of tile rows (bench.py:224-244): its
    spheres at rest plus the motion bound of 4 world units and two
    texels."""
    return sunmap.dirty_tile_rows(sf, tail.draw_position, tail.draw_mesh_row[:, 3] * tail.draw_scale, map_wh,
                                  margin=4.0 + 2.0 * texel)


def sun_tail(ds, sf, static, static_n: int, map_wh: int, texel: float, sun_caps: dict) -> SunTail:
    """The tail [static_n, D) of `ds` as its own sliced scene with its
    dirty band and the update budgets at tail scale
    (presets.sunmap_update_capacities)."""
    tail = ds.slice_draws(static_n, ds.num_draws)
    caps = presets.sunmap_update_capacities(ds.num_draws - static_n, sun_caps)
    return SunTail(sf=sf, static=static, packed_static=sunmap.pack_sun_map(static), tail=tail,
                   window=tail_window(sf, tail, map_wh, texel), caps=caps, map_wh=map_wh, texel=texel)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def probe(dev, smi: str) -> dict:
    """The card's name and power limit, and its measured device-to-device
    copy rate: PROBE_BYTES copied ten times, CUDA events, counted as the
    bytes read plus the bytes written a second (the H100 SXM's sheet
    figure is 3.35e12)."""
    out = dict(nvidia_smi=smi)
    if dev.type != "cuda":
        return dict(out, copy_bytes=None, copy_GBps=None)
    src = torch.ones(PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        dst.copy_(src)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 10
    return dict(out, copy_bytes=PROBE_BYTES, copy_ms=ms, copy_GBps=2 * PROBE_BYTES / (ms * 1e-3) / 1e9)


def make_scene(geometry, draws, k: dict, dev):
    """The headline scene (bench.py:84-100): with textures the planar uvs
    on a copy of the geometry and the checker materials, with the alpha
    class too (cooker.alpha_scene: 1/8 of the draws, the masks baked), the
    texture table; uploaded to `dev`.  Returns (device scene, texture
    table or None, geometry, draws, materials, mips)."""
    g, mats, masks, mips, table = geometry, None, None, None, None
    if k["TEXTURES"]:
        if k["ALPHA"]:
            g, draws, mats, masks, mips = cooker.alpha_scene(geometry, draws)
        else:
            g = dataclasses.replace(geometry)
            cooker.synthesize_planar_uvs(g)
            mats, mips, mat_idx, _ = cooker.synthesize_materials(draws.count)
            draws.material_index[:] = mat_idx
        table = textures.build_texture_table(mips)
    ds = scene_mod.from_numpy(scene_mod.upload(g, draws, mats, masks, texture_table=table), dev)
    return ds, None if table is None else textures.to_device(table, dev), g, draws, mats, mips


def warm(render, state, n: int = 2):
    """n frames from `state`, each waited for; returns the last output and
    the seconds."""
    t0 = time.perf_counter()
    for _ in range(n):
        image, fb, state, stats = render(state)
        float(image[0, 0, 0])
    return (image, fb, state, stats), time.perf_counter() - t0


def frames_of(dev, render, state, n: int) -> tuple[dict, tuple]:
    """n chained frames of `render` from `state`: each frame's ms, the mean
    (the value), the wall ms a frame, the last frame's drops."""
    ms, wall, out = chained(dev, n, lambda i, c: render(c[2]), (None, None, state, None))
    d = drops(out[3])
    return dict(value=float(np.mean(ms)), frame_ms=ms, wall_ms_per_frame=wall / n * 1e3, drops=d), out


def run(k: dict, dev) -> dict:
    cuda = dev.type == "cuda"
    res, losses = {}, []
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.lib()
        build_s = time.perf_counter() - t0
        log(f"kernels {'built by nvcc' if _build.build_info['seconds'] else 'loaded'} in {build_s:.1f} s -> "
            f"{_build.build_info['path']}")
    t0 = time.perf_counter()
    geometry = cooker.cook_procedural()
    log(f"procedural torus cooked or loaded from its scene cache in {time.perf_counter() - t0:.1f} s: "
        f"{geometry.meshes.count} mesh, {int(geometry.meshes.lod_index_count[0, 0]) // 3} LOD-0 triangles")

    parity = "skipped"
    if k["PARITY"]:
        from .render.parity import kernel_parity_check

        t0 = time.perf_counter()
        ps = kernel_parity_check(geometry, dev)
        parity = "exact"
        log(f"kernel parity: every kernel bit for bit against its plain version ({ps}) in "
            f"{time.perf_counter() - t0:.1f} s")

    D, W, H, n = k["DRAWS"], k["W"], k["H"], k["FRAMES"]
    t0 = time.perf_counter()
    draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=D)
    ds, tex, g, draws, mats, mips = make_scene(geometry, draws, k, dev)
    sync(dev)
    log(f"scene ready in {time.perf_counter() - t0:.1f} s: {D} draws, {ds.num_meshlets} meshlets, vis slots "
        f"{ds.meshlet_visibility_count}, textured={tex is not None} alpha_masks={ds.has_alpha_masks}")
    caps = capacities(D)
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2 if (k["ALPHA"] and k["TEXTURES"]) else 1,
                            shadows=bool(k["SUNMAP"]), **caps)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev)

    # the sun map: the static 98% built once, the animated tail's band
    # updated and spliced every frame (bench.py:143-268)
    sun, tail, anim_n = None, None, 0
    if k["SUNMAP"]:
        m = k["MAP"]
        anim_n = max(D // 50, 1) if k["ANIMATE"] else 0
        static_n = D - anim_n
        sf = sunmap.fit_sun_to_draws(sp.sun_direction, draws, device=dev)
        texel = sunmap.map_texel_world(sf, m, m)
        sun_caps = dict(cmd_capacity=cfg.cmd_capacity, cluster_capacity=cfg.cluster_capacity,
                        tri_capacity=min(cfg.tri_capacity, SUN_TRI_CAP), pair_capacity=cfg.pair_capacity)
        kw = dict(map_w=m, map_h=m, texel_world=texel, num_draws=static_n, **sun_caps)
        t0 = time.perf_counter()
        static, sdrop = sunmap.build_static_sun_map(ds, sf, **kw)
        sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        static, sdrop = sunmap.build_static_sun_map(ds, sf, **kw)
        sync(dev)
        res["sunmap_build_s"] = time.perf_counter() - t0
        res["sunmap_static_dropped"] = int(sdrop)
        losses.append(int(sdrop))
        smap = static
        if anim_n:
            tail = sun_tail(ds, sf, static, static_n, m, texel, sun_caps)
            smap, udrop = sunmap.update_sun_map(animate_tail(tail.tail, 0.0), sf, static, None, map_w=m, map_h=m,
                                                texel_world=texel, **tail.caps)
            losses.append(int(udrop))
        sun = (sf, sunmap.pack_sun_map(smap), (m, m))
        log(f"static sun map {m}x{m} of draws [0, {static_n}): first build {first_s:.2f} s, rebuild "
            f"{res['sunmap_build_s']:.3f} s, dropped {int(sdrop)}; {anim_n} animated draws")
        if anim_n:
            log(f"dirty sun-map window: tile rows {tail.window[0]}..{sum(tail.window)} of {m // 8}; update budgets "
                f"{tail.caps}")
            tail.update(0.3)
            n_upd = max(n, 3)
            ms, wall, drop = chained(dev, n_upd, lambda i, total: total + tail.update(0.3 * (i + 1))[1], 0)
            res["sunmap_update_ms"] = float(np.mean(ms))
            res["sunmap_update_dropped"] = int(drop)
            log(f"sun map update + pack_band {res['sunmap_update_ms']:.3f} ms a frame (each {[round(x, 3) for x in ms]}"
                f", wall {wall / n_upd * 1e3:.3f} ms a frame; {anim_n} animated draws, band {tail.window[1]} tile "
                f"rows), dropped {int(drop)}")

    def render(st):
        return frame.render_frame(ds, st, params, sp, cfg, textures=tex, sun=sun)

    # warm-up: two frames from a cold state (bench.py:274-292); the first
    # two overflow the late budgets by the reference's design
    out, warm_s = warm(render, state, 1)
    out2, warm2_s = warm(render, out[2], 1)
    res["warmup_s"] = warm_s + warm2_s
    log(f"first frame {warm_s:.2f} s, second {warm2_s * 1e3:.2f} ms; drops {drops(out2[3])}")

    for key in _build.LAUNCHES:
        _build.LAUNCHES[key] = 0
    head, (image, fb, state, stats) = frames_of(dev, render, out2[2], n)
    launches = {key: v for key, v in _build.LAUNCHES.items() if v}
    covered = int((fb.vis != 0x7FFFFFFF).sum())
    scope = ("cull+raster" + ("+alpha" if cfg.post_passes > 1 else "")
             + ("+textured shade" if tex is not None else "+shade") + ("+sunshadow" if sun else "") + "+bloom+final")
    res.update(static_drops=head["drops"], frame_ms=head["frame_ms"], wall_ms_per_frame=head["wall_ms_per_frame"],
               covered_px=covered, launches=launches)
    log(f"{head['value']:.3f} ms/frame over {n} chained frames ({scope}): each {[round(x, 3) for x in head['frame_ms']]}, "
        f"wall {head['wall_ms_per_frame']:.3f} ms a frame; covered px {covered}; demand tri "
        f"{int(stats.tri_count)}/{cfg.tri_capacity} pair {int(stats.pair_count)}/{cfg.pair_capacity}; steady-state "
        f"drops {head['drops']}; kernel launches {launches}")
    losses.append(head["drops"])
    state_static = state

    if k["STAGES"]:
        table, _ = staged(dev, n, lambda i, c, st: frame.render_frame(ds, c[2], params, sp, cfg, textures=tex, sun=sun,
                                                                      stages=st), (None, None, state, None))
        print_stages("the static frame", table)
        res["stages"] = {"static": table}

    if anim_n:
        # the animated full frame (bench.py:320-360): move the tail, update
        # its band, splice, move the scene's tail, render
        def anim_step(i, c, stages=None):
            t = 0.3 * (i + 1)
            packed, udrop = tail.update(t, stages)
            moved = animate_scene(ds, static_n, t)
            stage_marker(stages)("scene move")
            out = frame.render_frame(moved, c[0][2], params, sp, cfg, textures=tex, sun=(sun[0], packed, sun[2]),
                                     stages=stages)
            return out, c[1] + udrop

        ms, wall, (out, udrop) = chained(dev, n, anim_step, ((None, None, state, None), 0))
        ad = dict(drops(out[3]), sunmap=int(udrop))
        res.update(animated_frame_ms=float(np.mean(ms)), animated_frame_ms_each=ms, animated_drops=ad)
        losses.append(ad)
        log(f"animated full frame {res['animated_frame_ms']:.3f} ms/frame over {n} chained frames (move {anim_n} "
            f"draws + sun-map update + {scope}): each {[round(x, 3) for x in ms]}, wall {wall / n * 1e3:.3f} ms a "
            f"frame; drops {ad}")
        if k["STAGES"]:
            table, _ = staged(dev, n, anim_step, (out, 0))
            print_stages("the animated frame", table)
            res["stages"]["animated"] = table

    if k["SHADOW"]:
        res["rt"] = run_rt(dev, ds, g, draws, tex, cfg, params, sp, state_static, fb, n)
        losses.append(res["rt"]["drops"])
    if k["SHARDS"]:
        res["sharded"] = run_sharded(dev, k["SHARDS"], g, draws, mats, tex, cfg, params, sp, sun, n)
        losses.append(res["sharded"]["drops"])
    del ds, tex, state, state_static, out, out2, image, fb, stats, sun, tail
    if cuda:
        torch.cuda.empty_cache()
    if k["GLASS"]:
        res["glass"] = run_glass(dev, geometry, D, caps, W, H, n)
        losses.append(res["glass"]["drops"])
    if k["GLTF"]:
        res["gltf_scene"] = run_city(dev, W, H, n)
        losses.append(res["gltf_scene"]["drops"])

    smi = nvidia_smi()
    res["probe"] = probe(dev, smi) if k["PROBE"] else {}
    if k["PROBE"]:
        log(f"probe: {json.dumps(res['probe'])}")
    loss_free = all(lossless(x) if isinstance(x, dict) else x == 0 for x in losses)
    value = head["value"]
    return {
        "metric": f"torus_{D // 1000}k_draws_{W}x{H}_full_frame_time",
        "value": value,
        "unit": "ms",
        "vs_baseline": 16.7 / value,
        "warmup_s": res.pop("warmup_s"),
        "build_s": build_s,
        "kernel_parity": parity,
        "loss_free": loss_free,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        **res,
    }


def run_rt(dev, ds, g, draws, tex, cfg, params, sp, state, fb, n: int) -> dict:
    """bench.py's BENCH_SHADOW (bench.py:363-390): the BVH of the draws
    built on the host and refit, the shadow pass of the steady frame's
    depth at half resolution with bench.py's chunked budget; then n
    chained frames of render_frame(bvh=...) (quality 0) after two warm-up
    frames."""
    t0 = time.perf_counter()
    host_bvh, rt_static = shadow_ops.build_scene_rt(g, draws)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_bvh = shadow_ops.refit_tlas(rt_static, draws)
    refit_s = time.perf_counter() - t0
    bvh = host_bvh.to(dev)

    def shadow_pass():
        return shadow_ops.shadow_pass(fb.depth, bvh, sun_direction=sp.sun_direction,
                                      inverse_view_projection=sp.inverse_view_projection, width=cfg.width,
                                      height=cfg.height, scale=2, chunked=True)

    t0 = time.perf_counter()
    float(shadow_pass()[0, 0])
    first_s = time.perf_counter() - t0
    pass_ms, _, _ = chained(dev, 1, lambda i, c: shadow_pass(), None)
    rcfg = dataclasses.replace(cfg, shadows=True, shadow_quality=0)

    def render(st):
        return frame.render_frame(ds, st, params, sp, rcfg, textures=tex, bvh=bvh)

    out, _ = warm(render, state)
    r, _ = frames_of(dev, render, out[2], n)
    log(f"rt: TLAS build {build_s:.3f} s, refit {refit_s:.3f} s ({draws.count} instances); shadow_pass(scale=2, "
        f"chunked=True) first {first_s:.2f} s, then {pass_ms[0]:.3f} ms; RT frame {r['value']:.3f} ms over {n} "
        f"chained frames, each {[round(x, 3) for x in r['frame_ms']]}; drops {r['drops']}")
    return dict(r, tlas_build_s=build_s, refit_s=refit_s, shadow_pass_ms=pass_ms[0], shadow_pass_first_s=first_s)


def run_sharded(dev, n_shards: int, g, draws, mats, tex, cfg, params, sp, sun, n: int) -> dict:
    """The headline frame's draws in n_shards round-robin shards on this
    device (parallel/mesh.py, InProcess), materials only, the texture
    table and the sun map replicated; two warm-up and n chained frames."""
    from .parallel import mesh

    t0 = time.perf_counter()
    shards = mesh.shard_draws(g, draws, n_shards, mats, device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0
    coll = mesh.InProcess()

    def render(states):
        return mesh.render_sharded_frame(shards, states, params, sp, cfg, coll, textures=tex, sun=sun)

    out, _ = warm(render, mesh.init_sharded_state(shards))
    r, _ = frames_of(dev, render, out[2], n)
    log(f"sharded: {n_shards} shards of {shards[0].num_draws} draws (uploaded in {upload_s:.1f} s): "
        f"{r['value']:.3f} ms a frame over {n} chained frames, each {[round(x, 3) for x in r['frame_ms']]}; drops "
        f"{r['drops']}")
    return dict(r, shards=n_shards, upload_s=upload_s)


def run_glass(dev, geometry, D: int, caps: dict, W: int, H: int, n: int) -> dict:
    """The glass frame (cooker.glass_scene of D fresh draws: material 6's
    draws in the transmission class, materials 0-3 normal-mapped),
    post_passes=3, unshadowed; two warm-up and n chained frames."""
    t0 = time.perf_counter()
    g, d, mats, masks, mips = cooker.glass_scene(geometry, cooker.synthesize_draws(geometry.meshes.count,
                                                                                   draw_count=D))
    table = textures.build_texture_table(mips)
    ds = scene_mod.from_numpy(scene_mod.upload(g, d, mats, masks, texture_table=table), dev)
    tex = textures.to_device(table, dev)
    cfg = frame.FrameConfig(width=W, height=H, post_passes=3, **caps)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)

    def render(st):
        return frame.render_frame(ds, st, params, sp, cfg, textures=tex)

    out, _ = warm(render, frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev))
    setup_s = time.perf_counter() - t0
    r, _ = frames_of(dev, render, out[2], n)
    log(f"glass: {int((d.post_pass == 2).sum())} transmission and {int((d.post_pass == 1).sum())} alpha draws, set-up "
        f"{setup_s:.1f} s; {r['value']:.3f} ms a frame over {n} chained frames, each "
        f"{[round(x, 3) for x in r['frame_ms']]}; drops {r['drops']}")
    return dict(r, transmission_draws=int((d.post_pass == 2).sum()))


def run_city(dev, W: int, H: int, n: int) -> dict:
    """bench.py's glTF frame (bench.py:393-459): the procedural city at its
    defaults under .cache/city/ through .glb -> C++ cook (its scene cache
    when there is one) -> DDS decode -> opacity bake -> texture table,
    presets.scene_capacities, its camera and sun; two warm-up and n
    chained frames.  The set-up's seconds (the cook's too, cold or cached)
    are reported apart from the frame time."""
    from .cooker import gltf, opacity, synth_city

    secs = {}
    t0 = time.perf_counter()
    glb = synth_city.ensure_city(CITY_DIR)
    secs["generate"] = time.perf_counter() - t0
    cached = any(f.endswith(".scene.npz") for f in os.listdir(CITY_DIR))
    t0 = time.perf_counter()
    sd = gltf.load_scene(glb, cache_dir=CITY_DIR)
    secs["cook (cached)" if cached else "cook (cold)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mips, substituted = textures.load_texture_mips(sd.texture_paths, base_dir=CITY_DIR)
    masks = opacity.bake_opacity(sd.geometry, sd.draws, sd.materials, mips)
    table = textures.build_texture_table(mips)
    ds = scene_mod.from_numpy(scene_mod.upload(sd.geometry, sd.draws, sd.materials, masks, texture_table=table), dev)
    tex = textures.to_device(table, dev)
    sync(dev)
    secs["decode, bake, table, upload"] = time.perf_counter() - t0
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, **presets.scene_capacities(sd.geometry, sd.draws))
    cam = camera.Camera(position=sd.camera_position, orientation=sd.camera_orientation)
    params, sp = frame.make_frame_inputs(cam, camera.RenderSettings(), cfg, sun_direction=sd.sun_direction)

    def render(st):
        return frame.render_frame(ds, st, params, sp, cfg, textures=tex)

    out, secs["two warm-up frames"] = warm(render, frame.init_state(ds.num_draws, ds.meshlet_visibility_count, dev))
    r, (_, fb, _, stats) = frames_of(dev, render, out[2], n)
    covered = int((fb.vis != 0x7FFFFFFF).sum())
    log(f"gltf city: {sd.draws.count} draws, {ds.num_meshlets} meshlets, {len(sd.materials['diffuse'])} materials, "
        f"{len(sd.texture_paths)} textures ({len(substituted)} substituted), set-up seconds "
        f"{ {key: round(v, 2) for key, v in secs.items()} }; {r['value']:.3f} ms a frame over {n} chained frames, "
        f"each {[round(x, 3) for x in r['frame_ms']]}; covered px {covered}; demand tri {int(stats.tri_count)}/"
        f"{cfg.tri_capacity} pair {int(stats.pair_count)}/{cfg.pair_capacity}; drops {r['drops']}")
    return dict(r, frame_ms=r["value"], frame_ms_each=r["frame_ms"], draws=int(sd.draws.count),
                materials=int(len(sd.materials["diffuse"])), covered_px=covered, textures_substituted=len(substituted),
                setup_s=secs, **{f"drops_{key}": v for key, v in r["drops"].items() if key != "pair_vec"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m niagara_tpu_torch.bench",
                                 description="The port's benchmark: one JSON line on stdout (knobs: BENCH_* "
                                             "environment variables, see the module's docstring)")
    ap.add_argument("--device", default="cuda", help="cuda (the default: the first card) or cpu")
    opts = ap.parse_args(argv)
    dev = torch.device(opts.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("niagara_tpu_torch.bench: no CUDA device (torch.cuda.is_available() is false); the benchmark runs "
                  "on a card, or on the host with --device cpu", file=sys.stderr)
            return 2
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    print(json.dumps(run(knobs(), dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
