"""The two-pass frame (niagara_tpu/render/frame.py, direct tile path).

early draw cull (class 0) -> early cluster cull -> x-order -> setup ->
raster -> depth pyramid -> late draw cull (every class, merged) -> late
cluster cull (+ visibility write-back) -> late setup -> raster -> shade
(both streams) -> G-buffer -> composite.  The cull passes, the pyramid,
setup, raster and shade run the CUDA kernels on a GPU and their plain
torch versions on the CPU; nothing reads counts back to the host inside a
frame.

`post_passes=1` renders the opaque class; `post_passes=2` adds the
alpha-test class (postPass 1), which the late pass culls together with
class 0 and rasterizes in one merged stream through the raster kernel's
alpha_test variant (class group (0, 1), frame.py:135-143, 367-429); a scene
with opacity masks runs the setup kernel's alpha variant.  `render_frame`
samples textures when given a table, with `FrameConfig.shadows` and a
sun map (`sun`, ops/sunmap.py) resolves and blurs the sun's shadow term,
and with `FrameConfig.bloom` (the default, as the reference's) adds the
bloom chain of the G-buffer's emissive (ops/bloom.py) to the composite.
`post_passes=3` adds the transmission class (postPass 2): the late pass
splits its survivors into the groups (0, 1) and (2,), and the second
rasterizes into a layer of its own, shaded with one stream and blended in
the composite (frame.py:376-431, 592-629).  `occlusion_two_pass=False`
(configs 0 and 1) renders one early pass of every draw the cull passes,
class 0 only, with no pyramid and no late pass (frame.py:281-290, 561-581).
With `FrameConfig.shadows` and a ShadowBVH (`bvh`, ops/shadow.py) the
sun's shadow term is ray-traced instead (frame.py:672-685).  Fragment ids:
early records are [0, tri_capacity), the late group g's tri_capacity +
g * late_tri_capacity + [0, late_tri_capacity) (frame.py:389), all
shifted by frame_core's `frag_offset`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..config import TILE_H, TILE_W
from ..utils import math3d
from ..utils.profiling import span

from ..ops import bloom, cull, pyramid, raster_tile, setup, shade, shadow as shadow_ops, sunmap
from ..ops.raster import INVALID_FRAG, Framebuffer
from .camera import Camera, RenderSettings, make_cull_params


@dataclass
class FrameState:
    """Persistent cross-frame visibility (frame.py:31)."""

    draw_vis: torch.Tensor  # i32 [D]
    vis_words: torch.Tensor  # int64 [W] holding u32 bit words


@dataclass(frozen=True)
class FrameConfig:
    """Resolution and capacities (names and defaults of frame.py:40)."""

    width: int = 1920
    height: int = 1080
    cmd_capacity: int = 1 << 14
    cluster_capacity: int = 1 << 16
    pair_capacity: int = 1 << 21
    tri_capacity: int = 1 << 20
    candidate_capacity: int | None = None
    late_candidate_capacity: int | None = None
    late_cluster_capacity: int | None = None
    late_tri_capacity: int | None = None
    late_pair_capacity: int | None = None
    # (tiny2, small, midA, midB) pair-emission class budgets; None derives
    # them from the pass's tri capacity (emit_pairs)
    pair_class_caps: tuple | None = None
    # the giant pair class's budget (raster_tile.GIANT_CAPACITY)
    giant_capacity: int = raster_tile.GIANT_CAPACITY
    # False: one early pass over every draw the cull passes, no pyramid and
    # no late pass (configs 0 and 1, presets.frame_overrides)
    occlusion_two_pass: bool = True
    # the bloom chain of the emissive G-buffer, added to the composite
    bloom: bool = True
    # draw classes: 1 = opaque only; 2 adds the alpha-test class; 3 the
    # transmission class in its own layer
    post_passes: int = 1
    # sun shadows: the sun map (render_frame's `sun`) or ray-traced against
    # a ShadowBVH (`bvh`) at 1/shadow_scale resolution, half the pixels
    # traced with shadow_checkerboard; both blurred by the depth-aware
    # bilateral filter; shadow_quality 1 traces with the alpha test
    shadows: bool = False
    shadow_scale: int = 2
    shadow_checkerboard: bool = True
    shadow_blur: bool = True
    shadow_quality: int = 0

    def __post_init__(self):
        if self.post_passes not in (1, 2, 3):
            raise ValueError(f"post_passes must be 1, 2 or 3, got {self.post_passes}")

    @property
    def late_cluster_cap(self):
        return self.late_cluster_capacity or self.cluster_capacity

    @property
    def late_tri_cap(self):
        return self.late_tri_capacity or self.tri_capacity

    @property
    def late_pair_cap(self):
        return self.late_pair_capacity or self.pair_capacity

    @property
    def candidate_cap(self):
        return self.candidate_capacity or self.cluster_capacity

    @property
    def late_candidate_cap(self):
        return self.late_candidate_capacity or self.candidate_capacity or self.cluster_capacity

    @property
    def late_class_groups(self):
        """The late pass's raster grouping (frame.py:135): opaque and
        alpha-test classes share one stream, transmission gets its own
        layer."""
        return {1: ((0,),), 2: ((0, 1),)}.get(self.post_passes, ((0, 1), (2,)))

    @property
    def pyramid_levels_shape(self):
        return pyramid.pyramid_shape(self.width, self.height)


@dataclass
class ShadeParams:
    camera_position: np.ndarray  # f32 [3]
    sun_direction: np.ndarray  # f32 [3]
    inverse_view_projection: np.ndarray  # f32 [4,4]


@dataclass
class FrameStats:
    """Per-frame counters (frame.py:160), 0-d int64 tensors except the two
    [6] vectors."""

    early_commands: torch.Tensor  # emitted draws, early pass
    late_commands: torch.Tensor
    early_clusters: torch.Tensor
    late_clusters: torch.Tensor
    visible_draws: torch.Tensor
    cmd_dropped: torch.Tensor
    cluster_dropped: torch.Tensor
    tri_dropped: torch.Tensor
    pair_dropped: torch.Tensor
    pair_drop_vec: torch.Tensor  # per class: tiny2 small midA midB giant truncation
    pair_demand_vec: torch.Tensor  # per class: tiny1 tiny2 small midA midB giant
    candidates: torch.Tensor  # late-pass candidate clusters
    tri_count: torch.Tensor
    pair_count: torch.Tensor

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy() for f in fields(self)}


def init_state(num_draws: int, vis_slot_count: int, device) -> FrameState:
    """Everything invisible; an even word count (frame.py:196)."""
    return FrameState(
        draw_vis=torch.zeros(num_draws, dtype=torch.int32, device=device),
        vis_words=torch.zeros(-(-max(vis_slot_count, 64) // 64) * 2, dtype=torch.int64, device=device),
    )


def state_from_numpy(draw_vis: np.ndarray, vis_words: np.ndarray, device) -> FrameState:
    """FrameState from numpy (vis_words as u32 values, e.g. the reference's)."""
    return FrameState(
        draw_vis=torch.tensor(np.asarray(draw_vis, np.int32), device=device),
        vis_words=torch.tensor(np.asarray(vis_words).astype(np.int64), device=device),
    )


def state_to_numpy(state: FrameState) -> tuple[np.ndarray, np.ndarray]:
    """(draw_vis i32, vis_words u32) as the reference holds them."""
    return state.draw_vis.cpu().numpy(), state.vis_words.cpu().numpy().astype(np.uint32)


def frag_span(cfg: FrameConfig) -> int:
    """Fragment ids one frame_core call uses: the early pass's
    [0, tri_capacity), then one late_tri_capacity block per late group."""
    return cfg.tri_capacity + len(cfg.late_class_groups) * cfg.late_tri_cap


def frame_core(scene, state: FrameState, params, cfg: FrameConfig, capture: dict | None = None,
               frag_offset: int = 0, stages=None):
    """Cull + raster + attribute resolve for one frame.  Returns (fb,
    new_state, stats, attrs [H,W,13], layer): `layer` is the transmission
    class's own dict(depth, vis, attrs) with post_passes=3, else None.
    `frag_offset` shifts every fragment id of the frame (frame.py:258, 330,
    389), which gives each shard of a sharded frame (parallel/mesh.py) a
    range of its own; ids stay below INVALID_FRAG.

    A `capture` dict receives the inputs of every kernel call (chip_smoke.py
    replays them against the plain versions), in pass order ("passes":
    "early", then "late" for each opaque/alpha group and "glass" for the
    transmission group): "cull" [(pass, cull_pass_* keywords)] of each
    cull pass ("early", "late"), "pyramid" (depth, levels, ph, pw) or None
    without the late pass, "setup" [(tc, capacity)], "setup_out", "raster"
    [(tile_start, pair_tri, rec, frag offset, depth, vis) carried in],
    "raster_alpha_test", "shade" (streams, vis) and, with the layer,
    "shade_layer".

    Each stage is a utils.profiling.span: "early draw cull", "early
    cluster cull" (with the x-order and cluster metadata), "early setup",
    "early emit+sort+raster", "pyramid", "late cull", "late setup+raster"
    (the opaque/alpha group) and "layer setup+raster" (the transmission
    group), "shade" (both buffers and the stats).  `stages` (a
    StageTimer, begun by the caller) gets a boundary at the end of each
    and each pass's pair demand (raster_tile.count_pairs, named by the
    pass), and with the layer "glass clusters", the transmission group's
    surviving clusters against late_cluster_capacity.  Boundaries and
    counts only record: the outputs and the launches are those of
    stages=None."""
    assert cfg.width % TILE_W == 0 and cfg.height % TILE_H == 0, "render size must be a multiple of (8,128)"
    if not 0 <= frag_offset <= INVALID_FRAG - frag_span(cfg):
        raise ValueError(f"frag_offset {frag_offset}: the frame's ids [offset, offset + {frag_span(cfg)}) must stay "
                         f"below INVALID_FRAG ({INVALID_FRAG:#x})")
    dev = state.draw_vis.device
    levels, ph, pw = cfg.pyramid_levels_shape
    pyr_hw = (ph, pw)
    tiles_x, tiles_y = cfg.width // TILE_W, cfg.height // TILE_H
    raster_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, class_caps=cfg.pair_class_caps,
                     giant_capacity=cfg.giant_capacity)
    passes = []  # name, tc, capacity, setup out, raster stats, frag offset, carried depth/vis, alpha_test
    culls = []  # name, the cull pass's inputs

    def cull_pass(name, draw_vis, vis_words, atlas, late):
        """A cull pass's draw stage; its cluster stage is `clusters()`,
        which the early pass spans apart."""
        kw = dict(late=late, pyramid_shape=pyr_hw, draw_capacity=cfg.cmd_capacity,
                  candidate_capacity=cfg.late_candidate_cap if late else cfg.candidate_cap,
                  num_classes=cfg.post_passes if late else None)
        ckw = dict(cluster_capacity=cfg.late_cluster_cap if late else cfg.cluster_capacity,
                   class_groups=cfg.late_class_groups if late else None)
        culls.append((name, dict(draw_vis=draw_vis, vis_words=vis_words, atlas=atlas, **kw, **ckw)))
        drawn = cull.cull_draws(scene, params, draw_vis, vis_words, atlas, **kw)
        return drawn, lambda: cull.cull_clusters(scene, params, drawn, **ckw)

    def render_pass(name, tc, capacity, frag_offset, carry, pair_capacity, alpha_test=False):
        """Setup and raster of one pass onto `carry` = (depth, vis), None:
        cleared buffers.  The early pass spans its setup apart."""
        label = {"early": "early emit+sort+raster", "glass": "layer setup+raster"}.get(name, "late setup+raster")

        def set_up():
            return setup.setup_compact(tc, scene, params, cfg.width, cfg.height, capacity)

        def rasterize(st):
            return raster_tile.rasterize_tiles(st, *carry, pair_capacity=pair_capacity, frag_offset=frag_offset,
                                               alpha_test=alpha_test, **raster_kw)

        if name == "early":
            with span(stages, "early setup"):
                carry = carry or clear()
                st = set_up()
            with span(stages, label):
                out_depth, out_vis, rst = rasterize(st)
        else:
            with span(stages, label):
                carry = carry or clear()
                st = set_up()
                out_depth, out_vis, rst = rasterize(st)
        raster_tile.count_pairs(stages, name, rst)
        passes.append(dict(name=name, tc=tc, cap=capacity, st=st, rst=rst, off=frag_offset, carry=carry,
                           alpha=alpha_test))
        return out_depth, out_vis

    def clear():
        return (torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=dev),
                torch.full((cfg.height, cfg.width), INVALID_FRAG, dtype=torch.int32, device=dev))

    # early pass: last frame's visible draws and clusters.  Without the late
    # pass (occlusion_two_pass=False) nothing would ever turn visible, so it
    # renders every draw and cluster the cull passes (frame.py:281-290):
    # all-ones draw visibility and visibility words (u32 words in int64)
    with span(stages, "early draw cull"):
        if cfg.occlusion_two_pass:
            early_dvb, early_words = state.draw_vis, state.vis_words
        else:
            early_dvb, early_words = torch.ones_like(state.draw_vis), torch.full_like(state.vis_words, 0xFFFFFFFF)
        drawn_e, clusters_e = cull_pass("early", early_dvb, early_words, None, False)
    with span(stages, "early cluster cull"):
        ((tc_e, ccount_e),), _, ncmd_e, ddrop_e, cdrop_e, _ = clusters_e()
    depth, vis = render_pass("early", tc_e, cfg.tri_capacity, frag_offset, None, cfg.pair_capacity)

    layer_depth = layer_vis = None
    if cfg.occlusion_two_pass:
        # late pass: newly visible draws and clusters (and every visible draw
        # of the post classes), occlusion-tested against the early depth, with
        # the visibility write-back; one setup and raster per class group, at
        # fragment offset tri_capacity + g * late_tri_capacity (frame.py:389).
        # The transmission group (2,) rasterizes into its own cleared layer
        # and never touches the opaque depth/vis (frame.py:390-405)
        with span(stages, "pyramid"):
            pyramid_in = (depth, levels, ph, pw)
            atlas = pyramid.build_pyramid(*pyramid_in)
        with span(stages, "late cull"):
            drawn_l, clusters_l = cull_pass("late", state.draw_vis, state.vis_words, atlas, True)
            new_draw_vis = drawn_l.new_vis
            groups_l, new_words, ncmd_l, ddrop_l, cdrop_l, n_cand = clusters_l()
        for g, ((tc, ccount), group) in enumerate(zip(groups_l, cfg.late_class_groups)):
            off = frag_offset + cfg.tri_capacity + g * cfg.late_tri_cap
            if group == (2,):
                if stages is not None:
                    stages.count("glass clusters", ccount, cfg.late_cluster_cap)
                layer_depth, layer_vis = render_pass("glass", tc, cfg.late_tri_cap, off, None, cfg.late_pair_cap)
            else:
                depth, vis = render_pass("late", tc, cfg.late_tri_cap, off, (depth, vis), cfg.late_pair_cap,
                                         alpha_test=1 in group)

    def total(key, where="st"):
        return sum((p[where][key] for p in passes[1:]), passes[0][where][key])

    with span(stages, "shade"):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        if cfg.occlusion_two_pass:
            new_state = FrameState(draw_vis=new_draw_vis.to(torch.int32), vis_words=new_words)
            ccount_l = sum((c for _, c in groups_l), zero)
            visible_draws = new_draw_vis.sum()
        else:
            # the carried state stays meaningful without a late pass (frame.py:561-581)
            new_state = FrameState(draw_vis=drawn_e.new_vis.to(torch.int32), vis_words=state.vis_words)
            ncmd_l = ccount_l = ddrop_l = cdrop_l = n_cand = zero
            visible_draws = drawn_e.emit.sum()

        main = [p for p in passes if p["name"] != "glass"]
        streams = [p["rst"]["stream"] for p in main]
        attrs = raster_tile.shade_tiles(streams, vis)
        layer = None
        if layer_vis is not None:
            glass = passes[-1]["rst"]["stream"]
            layer = dict(depth=layer_depth, vis=layer_vis, attrs=raster_tile.shade_tiles([glass], layer_vis))
        if capture is not None:
            capture.update(
                cull=culls,
                pyramid=pyramid_in if cfg.occlusion_two_pass else None,
                passes=[p["name"] for p in passes],
                setup=[(p["tc"], p["cap"]) for p in passes],
                setup_out=[p["st"] for p in passes],
                raster=[(p["rst"]["tile_start"], p["rst"]["pair_tri"], p["st"]["rec"], p["off"], *p["carry"])
                        for p in passes],
                raster_alpha_test=tuple(p["alpha"] for p in passes),
                shade=(streams, vis),
                cluster_capacity=[cfg.cluster_capacity] + [cfg.late_cluster_cap] * (len(passes) - 1),
            )
            if layer is not None:
                capture["shade_layer"] = ([glass], layer_vis)
            else:
                capture.pop("shade_layer", None)

        stats = FrameStats(
            early_commands=ncmd_e,
            late_commands=ncmd_l,
            early_clusters=ccount_e,
            late_clusters=ccount_l,
            visible_draws=visible_draws,
            cmd_dropped=ddrop_e + ddrop_l,
            cluster_dropped=cdrop_e + cdrop_l,
            tri_dropped=total("dropped"),
            pair_dropped=total("dropped", "rst"),
            pair_drop_vec=total("drop_vec", "rst"),
            pair_demand_vec=total("demand_vec", "rst"),
            candidates=n_cand,
            tri_count=total("count"),
            pair_count=total("pair_count", "rst"),
        )
    return Framebuffer(depth=depth, vis=vis), new_state, stats, attrs, layer


def debug_inputs(capture: dict):
    """(tc, setup) of a captured frame for shade.debug_visualize: every
    pass's cluster metadata and setup outputs concatenated in fragment-id
    order, each pass's triangle cluster index shifted by the cluster
    capacities before it (frame.py:423-429)."""
    tcs = [tc for tc, _ in capture["setup"]]
    k_off = [0]
    for cap in capture["cluster_capacity"][:-1]:
        k_off.append(k_off[-1] + cap)
    tc = {k: torch.cat([t[k] for t in tcs]) for k in ("mi", "draw_id")}
    setup_all = dict(tri_k=torch.cat([st["tri_k"] + off for st, off in zip(capture["setup_out"], k_off)]))
    return tc, setup_all


def render_frame(scene, state: FrameState, params, shade_params: ShadeParams, cfg: FrameConfig,
                 textures=None, sun=None, bvh=None, capture: dict | None = None, stages=None):
    """Render one frame; `textures` (render.textures.TextureTable on the
    scene's device) textures the materials.  With `cfg.shadows`, `sun` =
    (sun frame, packed map, (map_h, map_w)) -- ops/sunmap.fit_sun_to_draws,
    pack_sun_map or pack_band -- shadows the sun light through the packed
    resolve at half resolution (frame.py:647-663, where the 3-tuple rides
    in `bvh`), and `bvh` (ops/shadow.ShadowBVH on the scene's device)
    through ops/shadow.shadow_pass (frame.py:672-685); giving both
    raises; without either the frame is unshadowed, as the reference's.
    With `cfg.bloom` the bloom of the masked g0 joins the composite
    (frame.py:643-646).  With post_passes=3 the transmission layer gets its
    own G-buffer from its own depth (frame.py:617-629) and blends in the
    composite.  `capture` receives frame_core's kernel inputs, the
    attribute planes ("attrs": the interpolated normal in channels 0-2),
    g0 and g1 ("g0", "g1": g1 holds the shading normal), the shade-time
    valid mask ("valid"), the shadow term ("shadow", None when
    unshadowed), the ray-traced pass's rays ("trace", shadow_pass) and the
    layer ("layer": its depth, vis and valid mask, or None).
    Its spans (utils.profiling.span) are frame_core's, then with the layer
    "layer G-buffer" (its G-buffer), "G-buffer" (the main one) and
    composite_frame's; `stages` (a StageTimer the caller has begun) gets
    their boundaries and frame_core's counts.
    Returns (image [H,W,3], fb, new_state, stats)."""
    if sun is not None and bvh is not None:
        raise ValueError("render_frame: give the sun map (`sun`) or the ray-traced BVH (`bvh`), not both")
    if capture is not None:
        capture.pop("trace", None)
    fb, new_state, stats, attrs, layer = frame_core(scene, state, params, cfg, capture=capture, stages=stages)
    ivp = shade_params.inverse_view_projection
    transmission = None
    if layer is not None:
        with span(stages, "layer G-buffer"):
            g0t, g1t, valid_t = shade.gbuffer_from_attrs(layer["attrs"], layer["vis"] != INVALID_FRAG, scene,
                                                         textures=textures, depth=layer["depth"],
                                                         inverse_view_projection=ivp)
            transmission = (g0t, g1t, layer["depth"], valid_t)
    with span(stages, "G-buffer"):
        g0, g1, valid = shade.gbuffer_from_attrs(attrs, fb.vis != INVALID_FRAG, scene, textures=textures,
                                                 depth=fb.depth, inverse_view_projection=ivp)
        if capture is not None:
            capture.update(attrs=attrs, g0=g0, g1=g1, valid=valid, layer=None if layer is None else dict(
                depth=layer["depth"], vis=layer["vis"], valid=valid_t))
    image = composite_frame(g0, g1, fb.depth, valid, params, shade_params, cfg, transmission=transmission, sun=sun,
                            bvh=bvh, capture=capture, stages=stages)
    return image, fb, new_state, stats


def composite_frame(g0, g1, depth, valid, params, shade_params: ShadeParams, cfg: FrameConfig, *, transmission=None,
                    sun=None, bvh=None, capture: dict | None = None, stages=None):
    """The image of a frame's G-buffer (frame.py:643-700): with `cfg.bloom`
    the bloom of g0, with `cfg.shadows` the sun's shadow term from `depth`
    through the packed sun map `sun` or the ShadowBVH `bvh` (render_frame
    says which), then the composite, blending `transmission` = (g0t, g1t,
    depth_t, valid_t) when given.  `capture` receives the shadow term
    ("shadow", None when unshadowed) and the ray-traced pass's rays
    ("trace").  Its spans are "bloom", "sun-map resolve+blur" or
    shadow_pass's ("rt rays+trace", "rt fill+blur"), and "composite";
    `stages` gets their boundaries and shadow_pass's count."""
    ivp = shade_params.inverse_view_projection
    bloom_img = None
    if cfg.bloom:
        with span(stages, "bloom"):
            bloom_img = bloom.sample_bloom_fullres(bloom.compute_bloom(g0, cfg.width, cfg.height), cfg.width,
                                                   cfg.height)
    shadow = None
    if cfg.shadows and sun is not None:
        sf, packed, map_shape = sun
        with span(stages, "sun-map resolve+blur"):
            shadow = sunmap.shadow_map_pass(
                depth, sf, None, inverse_view_projection=ivp, width=cfg.width,
                height=cfg.height, packed=packed, map_shape=map_shape, blur=cfg.shadow_blur, znear=params.znear)
    elif cfg.shadows and bvh is not None:
        shadow = shadow_ops.shadow_pass(
            depth, bvh, sun_direction=shade_params.sun_direction, inverse_view_projection=ivp, width=cfg.width,
            height=cfg.height, scale=cfg.shadow_scale, checkerboard=cfg.shadow_checkerboard, blur=cfg.shadow_blur,
            znear=params.znear, quality=cfg.shadow_quality, capture=capture, stages=stages)
    with span(stages, "composite"):
        if capture is not None:
            capture["shadow"] = shadow
        image = shade.composite(
            g0, g1, depth, valid,
            camera_position=shade_params.camera_position, sun_direction=shade_params.sun_direction,
            inverse_view_projection=ivp, width=cfg.width, height=cfg.height,
            shadow=shadow, bloom=bloom_img, transmission=transmission,
        )
    return image


def make_frame_inputs(camera: Camera, settings: RenderSettings, cfg: FrameConfig, sun_direction=None):
    """Host-side per-frame constants: (CullParams, ShadeParams) (frame.py:703),
    in the span "frame inputs"."""
    with span(None, "frame inputs"):
        _, ph, pw = cfg.pyramid_levels_shape
        params, projection = make_cull_params(camera, cfg.width, cfg.height, pw, ph, settings)
        inv_vp = np.linalg.inv(projection @ np.asarray(params.view)).astype(np.float32)
        if sun_direction is None:
            sun_direction = math3d.normalize(np.array([1.0, 1.0, 1.0], dtype=np.float32))
        sp = ShadeParams(
            camera_position=np.asarray(camera.position, dtype=np.float32),
            sun_direction=np.asarray(sun_direction, dtype=np.float32),
            inverse_view_projection=inv_vp,
        )
    return params, sp
