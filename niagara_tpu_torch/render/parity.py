"""The kernel-vs-plain gate (the port's counterpart of
niagara_tpu/render/parity.py::mosaic_parity_check).

The reference certifies its Mosaic-compiled Pallas kernels against their
interpreted semantics before a benchmark records numbers.  The port's
kernels are hand-written CUDA, each with a plain torch version that the
CPU tests hold to the reference: this gate replays a frame's kernel calls
on the card and holds each kernel's output to its plain version's on the
same inputs, bit for bit.

`replay_frame` (with `replay_cull`), `replay_gbuffer`,
`replay_shadow_resolve`, `replay_band` (of `band_args`), `replay_bloom`
and `replay_trace` are the replays (the end-to-end check chip_smoke.py
times and bounds the calls they return); `kernel_parity_check`,
chip_smoke.py's "gate" phase, renders the small opaque and alpha scenes
with their sun maps on the card and runs all six, so every kernel
instance is held: cull.cu's draw_cull, cluster_cull and cluster_order
kernels on both cull passes (with and without the merged classes and the
write-back) and its two pyramid kernels, setup_kernel<false> and <true>,
raster_tile<false> and <true> over the whole grid and over a band
(band_row0), shade_px, gbuffer_px untextured and textured, shadowmap.cu's
resolve_blur, the four bloom kernels and trace_any_hit<false> and <true>.
Any difference raises ParityError on the first output that differs.
"""

from __future__ import annotations

import time

import torch

from ..config import TILE_H, TILE_W
from ..ops.raster import INVALID_FRAG


# the small scenes' sun map: its size and budgets (chip_smoke.py's "sun small" too)
SUN_MAP = 256
SUN_CAPS = dict(cmd_capacity=256, cluster_capacity=1024, tri_capacity=1 << 14, pair_capacity=1 << 15)


class ParityError(AssertionError):
    """A kernel's output differs from its plain version's."""


def expect(cond, msg: str) -> None:
    if not cond:
        raise ParityError(msg)


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a, b, what: str) -> None:
    """Raise ParityError unless two tensors (or dicts, tuples, lists of
    them) are equal bit for bit (floats compared as their int32 words)."""
    if isinstance(a, dict):
        expect(set(a) == set(b), f"{what}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            same_bits(a[k], b[k], f"{what}[{k}]")
        return
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(x, y, f"{what}[{i}]")
        return
    expect(a.shape == b.shape and a.dtype == b.dtype, f"{what}: shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if not torch.equal(_bits(a), _bits(b)):
        n = int((_bits(a) != _bits(b)).sum())
        err = float((a.double() - b.double()).abs().nan_to_num(float("inf")).max()) if a.is_floating_point() else None
        raise ParityError(f"{what}: {n} of {a.numel()} elements differ" + (f", max |diff| {err:.3e}" if err else ""))


def replay_cull(capture: dict, scene, params) -> list[dict]:
    """Every cull pass of a frame captured by frame_core (`capture["cull"]`)
    through csrc/cull.cu's kernels (ops/cull.py cull_pass_cuda) against the
    plain twin (cull_pass_plain) on the same inputs, and the late pass's
    depth pyramid (`capture["pyramid"]`, pyramid_cuda against
    build_pyramid_plain): emit, lod, new_vis, each class group's x-ordered
    setup metadata and count, the visibility words and the counts, and the
    atlas, bit for bit.  Returns records in replay_frame's form ("cull" of
    module "cull", "pyramid" of module "pyramid")."""
    from ..ops import cull, pyramid

    calls = []
    for pass_, kw in capture["cull"]:
        k_out, p_out = cull.cull_pass_cuda(scene, params, **kw), cull.cull_pass_plain(scene, params, **kw)
        same_bits(k_out, p_out, f"cull {pass_}")
        counts = "/".join(str(int(c)) for c in k_out["counts"])
        calls.append(dict(name="cull", pass_=pass_, module="cull", fn="cull_pass_cuda", plain="cull_pass_plain",
                          args=(scene, params), kwargs=kw, out=k_out,
                          lines=[f"cull {pass_}: {int(k_out['emit'].sum())} draws emitted, {int(k_out['n_draws'])} "
                                 f"listed ({int(k_out['draw_dropped'])} dropped), {int(k_out['n_candidates'])} "
                                 f"candidates -> {counts} clusters ({int(k_out['cluster_dropped'])} over capacity), "
                                 "bit for bit (max_abs_err 0.0)"]))
    if capture.get("pyramid") is not None:
        args = capture["pyramid"]
        k_out = pyramid.pyramid_cuda(*args)
        same_bits(k_out, pyramid.build_pyramid_plain(*args), "pyramid")
        calls.append(dict(name="pyramid", pass_="late", module="pyramid", fn="pyramid_cuda",
                          plain="build_pyramid_plain", args=args, kwargs={}, out=k_out,
                          lines=[f"pyramid: {tuple(args[0].shape)} depth -> {tuple(k_out.shape)} atlas, bit for bit "
                                 "(max_abs_err 0.0)"]))
    return calls


def replay_frame(capture: dict, scene, params, cfg) -> list[dict]:
    """Every cull (replay_cull), setup, raster and shade call of a frame captured by
    frame_core (`capture`), replayed: the kernel wrapper against its plain
    version on the same inputs, each output bit for bit.  Raster calls are
    also replayed as a tie merge (the pass's records onto its own result
    at a higher fragment offset: every pixel ties and must go to the
    smaller id, giving the result again) and, for the alpha_test variant
    on a pass with masked records, with seeded random mask bits (which
    must discard pixels).  Returns one record per call, in call order:
    kernel name, pass, wrapper module and function ("cull"/"pyramid"/
    "setup"/"raster_tile", "cull_pass_cuda"/"pyramid_cuda"/"setup_cuda"/
    "raster_cuda"/"shade_cuda", with `plain` the plain
    version's name), `args` and `kwargs` of the call, the kernel's output
    (`out`) and lines describing what was held (`lines`)."""
    from ..ops import raster_tile, setup

    W, H, tiles_x = cfg.width, cfg.height, cfg.width // TILE_W
    calls = replay_cull(capture, scene, params)
    for pass_, (tc, cap) in zip(capture["passes"], capture["setup"]):
        name = "setup_alpha" if "alpha" in tc else "setup"
        args = (tc, scene, params, W, H, cap)
        k_out, p_out = setup.setup_cuda(*args), setup.setup_plain(*args)
        same_bits(k_out, p_out, f"{name} {pass_}")
        calls.append(dict(name=name, pass_=pass_, module="setup", fn="setup_cuda", plain="setup_plain", args=args,
                          kwargs={}, out=k_out,
                          lines=[f"{name} {pass_}: {int(tc['count'][0])} clusters -> {int(k_out['count'])} triangles "
                                 f"({int(k_out['dropped'])} over capacity), bit for bit (max_abs_err 0.0)"]))

    for pass_, rargs, alpha in zip(capture["passes"], capture["raster"], capture["raster_alpha_test"]):
        name = "raster_alpha" if alpha else "raster"
        args = (*rargs, tiles_x)
        ts, pt, rec, off, d0, v0, _ = args
        shifted = raster_tile.raster_cuda(ts, pt, rec, off + cfg.tri_capacity + cfg.late_tri_cap, d0, v0, tiles_x,
                                          alpha_test=alpha)
        cases = [("", args), (" tie merge", (ts, pt, rec, off, *shifted, tiles_x))]
        lines = []
        # a scene uploaded without masks (the sharded frame's shards) has no
        # masked record to give random bits
        if alpha and bool((rec[:, 54] > 0).any()):
            gen = torch.Generator(device=rec.device).manual_seed(0)
            bits = torch.randint(0, 1 << 16, (rec.shape[0], 4), generator=gen, device=rec.device).float()
            noisy = rec.clone()
            noisy[:, 48:52] = torch.where((rec[:, 54] > 0)[:, None], bits, rec[:, 48:52])
            cases.append((" random masks", (ts, pt, noisy, *args[3:])))
            r = rec[torch.unique(pt[:int(ts[-1])].long())]
            r = r[r[:, 54] > 0]
            lines.append(f"{name} {pass_}: {int((r[:, 48:52] != 65535).any(dim=1).sum())} of {r.shape[0]} masked "
                         "records have a clear mask cell")
        results, discard = [], ""
        for case, a in cases:
            k_out = raster_tile.raster_cuda(*a, alpha_test=alpha)
            same_bits(k_out, raster_tile.raster_plain(*a, alpha_test=alpha), f"{name} {pass_}{case}")
            results.append(k_out[1])
            if alpha and case != " tie merge":
                # what the masks do: the same inputs without the mask test
                changed = int((raster_tile.raster_cuda(*a, alpha_test=False)[1] != k_out[1]).sum())
                what = "random masks" if case else "the path's masks"
                discard += f", {what} change {changed} px vs the test off"
                expect(case == "" or changed > 0, f"{name} {pass_}: random masks discard nothing")
        expect(torch.equal(results[0], results[1]), f"{name} {pass_}: the tie merge must give the pass's result")
        lines.append(f"{name} {pass_}: {int(ts[-1])} pairs, depth and vis bit for bit (tie merge"
                     f"{', random masks' if len(cases) > 2 else ''} too, max_abs_err 0.0){discard}")
        calls.append(dict(name=name, pass_=pass_, module="raster_tile", fn="raster_cuda", plain="raster_plain",
                          args=args, kwargs=dict(alpha_test=alpha), out=None, lines=lines))

    # the main visibility buffer's streams, then the transmission layer's
    # one stream over its own buffer
    layers = [("", capture["shade"])] + ([(" layer", capture["shade_layer"])] if "shade_layer" in capture else [])
    for what, (streams, vis) in layers:
        k_out = raster_tile.shade_cuda(streams, vis)
        same_bits(k_out, raster_tile.shade_plain(streams, vis), f"shade{what}")
        calls.append(dict(name="shade", pass_=f"shade{what}", module="raster_tile", fn="shade_cuda",
                          plain="shade_plain", args=(streams, vis), kwargs={}, out=k_out,
                          lines=[f"shade{what}: {len(streams)} streams, {int((vis != INVALID_FRAG).sum())} covered px, "
                                 "bit for bit (max_abs_err 0.0)"]))
    return calls


def replay_gbuffer(capture: dict, scene, textures, inverse_view_projection) -> list[dict]:
    """The G-buffers of a frame captured by render_frame (`capture`: the
    main attribute planes "attrs" over its visibility buffer and depth,
    and the transmission layer's, "layer", when the frame has one)
    through csrc/gbuffer.cu (ops/shade.py gbuffer_cuda) against the plain
    twin (gbuffer_plain) on the same inputs: g0, g1 and valid bit for bit,
    the kernel's count of shaded pixels equal to the twin's valid pixels,
    and both equal to what the frame itself wrote.  Returns records in
    replay_frame's form ("gbuffer" of module "shade")."""
    from ..ops import shade

    layers = [("", capture["attrs"], capture["shade"][1], capture["depth"], (capture["g0"], capture["g1"],
                                                                           capture["valid"]))]
    lay = capture.get("layer")
    if lay is not None:
        layers.append((" layer", lay["attrs"], lay["vis"], lay["depth"], (lay["g0"], lay["g1"], lay["valid"])))
    calls = []
    for what, attrs, vis, depth, frame_out in layers:
        args = (attrs, vis != INVALID_FRAG, scene, textures)
        kw = dict(depth=depth, inverse_view_projection=inverse_view_projection)
        *k_out, shaded = shade.gbuffer_cuda(*args, **kw)
        p_out = shade.gbuffer_plain(*args, **kw)
        same_bits(tuple(k_out), p_out, f"gbuffer{what}")
        same_bits(tuple(k_out), frame_out, f"gbuffer{what} against the frame's")
        n = int(p_out[2].sum())
        expect(int(shaded[0]) == n, f"gbuffer{what}: the kernel counted {int(shaded[0])} pixels, the twin {n}")
        calls.append(dict(name="gbuffer", pass_=f"gbuffer{what}", module="shade", fn="gbuffer_cuda",
                          plain="gbuffer_plain", args=args, kwargs=kw, out=k_out,
                          lines=[f"gbuffer{what}: {int(args[1].sum())} covered px -> {n} shaded, g0, g1 and valid "
                                 "bit for bit (max_abs_err 0.0)"]))
    return calls


def replay_shadow_resolve(capture: dict, sun, inverse_view_projection, cfg, znear: float) -> list[dict]:
    """The sun-map resolve of a frame captured by render_frame with `sun` =
    (sun frame, packed map, (map_h, map_w)) (`capture`: its depth "depth"
    and shadow term "shadow") through csrc/shadowmap.cu (ops/sunmap.py
    shadow_resolve_cuda) against the plain twin (shadow_map_plain) on the
    same inputs, as composite_frame calls it: the term bit for bit, the
    kernel's count of tested texels equal to the half-resolution depth's
    texels above 0, and both terms equal to the frame's own.  Returns
    records in replay_frame's form ("shadow_resolve" of module
    "sunmap")."""
    from ..ops import sunmap

    sf, packed, map_shape = sun
    depth = capture["depth"]
    args = (depth, sf, packed, map_shape)
    kw = dict(inverse_view_projection=inverse_view_projection, width=cfg.width, height=cfg.height,
              blur=cfg.shadow_blur, znear=znear)
    k_out, tested = sunmap.shadow_resolve_cuda(*args, **kw)
    p_out = sunmap.shadow_map_plain(depth, sf, None, packed=packed, map_shape=map_shape, **kw)
    same_bits(k_out, p_out, "shadow_resolve")
    same_bits(k_out, capture["shadow"], "shadow_resolve against the frame's")
    n = int(sunmap.tested_texels(depth, cfg.width, cfg.height, 2))
    expect(int(tested[0]) == n, f"shadow_resolve: the kernel counted {int(tested[0])} texels, the depth has {n}")
    shadowed = int((p_out < 1.0).sum())
    return [dict(name="shadow_resolve", pass_="shadow_resolve", module="sunmap", fn="shadow_resolve_cuda",
                 plain="shadow_map_plain", args=args, kwargs=kw, out=(k_out, tested),
                 lines=[f"shadow_resolve: {n} texels tested on a {map_shape[1]}x{map_shape[0]} map, {shadowed} px "
                        f"below 1, blur {'on' if cfg.shadow_blur else 'off'}, bit for bit (max_abs_err 0.0)"])]


def band_args(setup_out, cfg, row0: int, n_rows: int) -> tuple:
    """raster_cuda's arguments for the band of tile rows [row0, row0 +
    n_rows) of one pass's set-up triangles (`setup_out`), as the sun map's
    band update renders it (ops/sunmap.py): the band's pairs (emit_pairs'
    row_window) onto a cleared band at fragment offset 0."""
    from ..ops import raster_tile

    tiles_x, tiles_y = cfg.width // TILE_W, cfg.height // TILE_H
    pairs = raster_tile.emit_pairs(setup_out, tiles_x=tiles_x, tiles_y=tiles_y, pair_capacity=cfg.late_pair_cap,
                                   row_window=(row0, n_rows), giant_capacity=cfg.giant_capacity)
    depth = torch.zeros((n_rows * TILE_H, cfg.width), dtype=torch.float32, device=setup_out["rec"].device)
    vis = torch.full(depth.shape, INVALID_FRAG, dtype=torch.int32, device=depth.device)
    return pairs["tile_start"], pairs["pair_tri"], setup_out["rec"], 0, depth, vis, tiles_x


def replay_band(args, row0: int) -> list[dict]:
    """A band raster call (`args`: raster_cuda's positional arguments, the
    band's depth and vis carried in) replayed through both raster
    instances with `band_row0=row0`, each against raster_plain bit for
    bit, with a tie merge (the band onto its own result at a higher
    fragment offset gives that result again).  Returns one record per
    instance ("raster_window", "raster_alpha_window"), in replay_frame's
    form."""
    from ..ops import raster_tile

    ts, pt, rec, off, d0, v0, tiles_x = args
    calls = []
    for alpha in (False, True):
        name = "raster_alpha_window" if alpha else "raster_window"
        kw = dict(alpha_test=alpha, band_row0=row0)
        what = f"{name} band rows {row0 * TILE_H}..{row0 * TILE_H + d0.shape[0]}"
        shifted = raster_tile.raster_cuda(ts, pt, rec, off + rec.shape[0], d0, v0, tiles_x, **kw)
        results = []
        for case, a in (("", args), (" tie merge", (ts, pt, rec, off, *shifted, tiles_x))):
            k_out = raster_tile.raster_cuda(*a, **kw)
            same_bits(k_out, raster_tile.raster_plain(*a, **kw), what + case)
            results.append(k_out[1])
        expect(torch.equal(results[0], results[1]), f"{what}: the tie merge must give the band's result")
        written = int((results[0] != v0).sum())
        calls.append(dict(name=name, pass_="band", module="raster_tile", fn="raster_cuda", plain="raster_plain",
                          args=args, kwargs=kw, out=None, written=written,
                          lines=[f"{what}: {int(ts[-1])} pairs, {written} px written, depth and vis bit for bit "
                                 "(tie merge too, max_abs_err 0.0)"]))
    return calls


def replay_bloom(g0, width: int, height: int, seed: int = 6) -> dict:
    """bloom.cu's kernels on a frame's g0 with its emissive channel
    replaced by seeded nonzero values (the scenes' own is 0): the frame's
    calls one by one, each against its plain version on the same input:
    bloom_down on each level above the tail's start, the tail (bloom_tail
    from `tail_start`) with every level it writes against tail_plain's,
    bloom_up back up and bloom_x2; then compute_bloom and
    sample_bloom_fullres against the plain chain, all bit for bit.  Returns
    the seeded g0, the mip chain, the tail's start, the calls in order
    (name, `kernel` and `plain` callables, the input `src`, for bloom_up
    `mip`, for bloom_tail its level count `n`; `levels` compared) and the
    chain's outputs."""
    from ..ops import bloom

    gen = torch.Generator(device=g0.device).manual_seed(seed)
    g0 = g0.clone()
    g0[..., 3] = torch.rand(g0.shape[:2], generator=gen, device=g0.device) * 0.6 + 0.05
    mips = [bloom.extract_emissive(g0, width, height)]
    levels = bloom.bloom_levels(width, height)
    for _ in range(1, levels):
        mips.append(bloom._down2(mips[-1]))
    start = min(bloom.tail_start(levels, *mips[0].shape[1:]), levels - 1)
    calls = []

    def level(name, kernel, plain, **inputs):
        out = plain()
        same_bits(kernel(), out, f"{name} on {tuple(inputs['src'].shape)}")
        calls.append(dict(name=name, kernel=kernel, plain=plain, out=out, levels=1, **inputs))
        return out

    for src in mips[:start]:
        level("bloom_down", lambda s=src: bloom.down2_cuda(s), lambda s=src: bloom._down2(s), src=src)
    acc = mips[start]
    if levels - start >= 2:
        src, n = mips[start], levels - start
        written = [f"level {start + k} (down)" for k in range(1, n)] + [f"level {start + k} (up)"
                                                                       for k in range(n - 2, -1, -1)]
        got, plain = bloom.tail_cuda(src, n), bloom.tail_plain(src, n)
        expect(len(got) == len(plain) == len(written), f"bloom_tail wrote {len(got)} levels, not {len(written)}")
        for what, k_out, p_out in zip(written, got, plain):
            same_bits(k_out, p_out, f"bloom_tail {what} from {tuple(src.shape)}")
        calls.append(dict(name="bloom_tail", kernel=lambda: bloom.tail_cuda(src, n),
                          plain=lambda: bloom.tail_plain(src, n), out=plain, levels=len(plain), src=src, n=n))
        acc = plain[-1]
    for i in range(start - 1, -1, -1):
        acc = level("bloom_up", lambda s=acc, m=mips[i]: bloom.up2_add_cuda(s, m),
                    lambda s=acc, m=mips[i]: bloom.up2_add_plain(s, m), src=acc, mip=mips[i])
    level("bloom_x2", lambda s=acc: bloom.bilinear_x2_cuda(s, height, width),
          lambda s=acc: bloom._bilinear_x2(s, height, width).permute(1, 2, 0), src=acc)

    half = bloom.compute_bloom(g0, width, height)
    plain_half = bloom.bloom_chain(g0, width, height, bloom._down2, bloom.up2_add_plain)
    same_bits(half, plain_half, "compute_bloom against the plain chain")
    full = bloom.sample_bloom_fullres(half, width, height)
    same_bits(full, bloom._bilinear_x2(plain_half, height, width).permute(1, 2, 0),
              "sample_bloom_fullres against the plain expansion")
    expect(bool((half > 0).all()), "the bloom of a nonzero emissive is not positive")
    return dict(g0=g0, mips=mips, levels=levels, start=start, calls=calls, half=half, full=full)


def replay_trace(bvh, trace: dict, counters: bool = False) -> dict:
    """A shadow pass's rays (shadow_pass's capture["trace"]) replayed: the
    kernel (trace_any_hit<alpha_test>, taking the rays in the pass's
    order) against the pass's own flags, and on the whole card's grid and
    on one block (whose four warps then refill their lanes many times)
    against trace_plain on the same tensors, every flag and step count
    equal.  Returns the kernel's name, the plain loop's flags, steps, its
    seconds and, with `counters`, its per-ray counters
    (shadow.trace_plain)."""
    from ..ops import shadow

    o, d, alpha, budget = trace["origin"], trace["direction"], trace["alpha_test"], trace["max_steps"]
    name = "trace_alpha" if alpha else "trace"
    run = dict(max_steps=budget, alpha_test=alpha, order=trace.get("order"))
    k_occ, k_steps = shadow.trace_cuda(bvh, o, d, **run)
    same_bits(k_occ, trace["occluded"], f"{name}: the replay against the frame's flags")
    t0 = time.perf_counter()
    p_occ, p_steps, *counts = shadow.trace_plain(bvh, o, d, max_steps=budget, alpha_test=alpha, counters=counters)
    if o.device.type == "cuda":
        torch.cuda.synchronize(o.device)
    plain_s = time.perf_counter() - t0
    same_bits((k_occ, k_steps), (p_occ, p_steps), f"{name} against trace_plain")
    same_bits(shadow.trace_cuda(bvh, o, d, blocks=1, **run), (p_occ, p_steps),
              f"{name} on one block against trace_plain")
    return dict(name=name, occluded=p_occ, steps=p_steps, budget=budget, plain_s=plain_s,
                counts=counts[0] if counts else None)


def kernel_parity_check(geometry, device, *, width: int = 256, height: int = 128) -> dict:
    """The gate: the small opaque scene (cooker.small_scene_draws of
    `geometry`, post_passes=1) and the small alpha scene
    (cooker.small_alpha_scene, post_passes=2) rendered on the card, two
    frames each from a cold state with `capture={}`; each second frame's
    cull passes, pyramid, setup (no-alpha and alpha), raster (opaque and
    alpha_test) and shade calls replayed (replay_frame) and its G-buffer
    (replay_gbuffer: untextured on the opaque frame, textured with the
    alpha discard on the alpha frame) and its sun-map resolve
    (replay_shadow_resolve: each scene's static 256x256 sun map, the
    frames rendered with it), a band of the alpha frame's late pass
    (replay_band: both raster instances with a nonzero band_row0), the
    bloom levels on its g0 (replay_bloom), and one trace_any_hit batch of
    each instance: the shadow pass's rays from its depth without and with
    the alpha test (replay_trace).  Raises ParityError on the first bit
    that differs, RuntimeError on a device without the kernels (the CPU:
    there is nothing to compare).  Returns counts of what was held, as the
    reference's returns setup_records_live and covered_px."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel_parity_check: no CUDA kernels run on {dev}, so there is nothing to compare with "
                           "their plain versions")
    return replay_small_scene(geometry, dev, width=width, height=height)


def replay_small_scene(geometry, device, *, width: int = 256, height: int = 128) -> dict:
    """kernel_parity_check's renders and replays on `device`, which the
    caller has checked: on the card the kernel wrappers launch their
    kernels; on the CPU they raise, unless a test has pointed them at
    their plain versions."""
    from .. import cooker, scene as scene_mod
    from ..ops import shadow, sunmap
    from . import camera, frame, presets, textures

    dev = torch.device(device)

    def two_frames(sc, draws, post_passes, tex=None):
        cfg = frame.FrameConfig(width=width, height=height, post_passes=post_passes, shadows=True,
                                **presets.small_capacities())
        params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        sf = sunmap.fit_sun_to_draws(sp.sun_direction, draws, device=dev)
        static, drop = sunmap.build_static_sun_map(sc, sf, map_w=SUN_MAP, map_h=SUN_MAP, **SUN_CAPS)
        expect(int(drop) == 0, f"a parity scene's sun map dropped {int(drop)}")
        sun = (sf, sunmap.pack_sun_map(static), (SUN_MAP, SUN_MAP))
        state = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, dev)
        cap = {}
        for _ in range(2):
            _, fb, state, _ = frame.render_frame(sc, state, params, sp, cfg, textures=tex, sun=sun, capture=cap)
        live = sum(int(st["count"]) for st in cap["setup_out"])
        covered = int((fb.vis != INVALID_FRAG).sum())
        expect(live > 0 and covered > 100, f"a parity scene rendered {live} triangles over {covered} px")
        held["live"] += live
        held["covered"] += covered
        return cfg, params, sp, cap, fb, sun

    def replays(sc, tex, cfg, params, sp, cap, sun):
        ivp = sp.inverse_view_projection
        return (replay_frame(cap, sc, params, cfg) + replay_gbuffer(cap, sc, tex, ivp)
                + replay_shadow_resolve(cap, sun, ivp, cfg, params.znear))

    held = dict(live=0, covered=0)
    draws = cooker.small_scene_draws(geometry.meshes.count)
    opaque = scene_mod.from_numpy(scene_mod.upload(geometry, draws), dev)
    cfg, params, sp, cap, _, sun = two_frames(opaque, draws, 1)
    calls = replays(opaque, None, cfg, params, sp, cap, sun)
    g, d, mats, masks, mips = cooker.small_alpha_scene(geometry)
    table = textures.build_texture_table(mips)
    sc = scene_mod.from_numpy(scene_mod.upload(g, d, mats, masks, texture_table=table), dev)
    tex = textures.to_device(table, dev)
    cfg, params, sp, cap, fb, sun = two_frames(sc, d, 2, tex)
    calls += replays(sc, tex, cfg, params, sp, cap, sun)
    row0 = height // TILE_H // 4  # tile rows 4-11 of 16 at 256x128
    band = replay_band(band_args(cap["setup_out"][-1], cfg, row0, 2 * row0), row0)
    expect(all(c["written"] > 0 for c in band), "the band replay covers no pixel")
    calls += band
    bl = replay_bloom(cap["g0"], width, height)
    bvh = shadow.build_scene_rt(g, d, mats, mips)[0].to(dev)
    rays = occluded = 0
    for quality in (0, 1):
        tcap = {}
        shadow.shadow_pass(fb.depth, bvh, sun_direction=sp.sun_direction,
                           inverse_view_projection=sp.inverse_view_projection, width=width, height=height,
                           quality=quality, capture=tcap)
        tr = replay_trace(bvh, tcap["trace"])
        rays += tr["occluded"].numel()
        occluded += int(tr["occluded"].sum())
    return dict(setup_records_live=held["live"], covered_px=held["covered"],
                calls={k: sum(c["name"] == k for c in calls) for k in dict.fromkeys(c["name"] for c in calls)},
                bloom_levels=sum(c["levels"] for c in bl["calls"]), rays=rays, occluded_rays=occluded)
