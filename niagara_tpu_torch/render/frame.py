"""The two-pass frame (niagara_tpu/render/frame.py, direct tile path).

early draw cull (class 0) -> early cluster cull -> x-order -> setup ->
raster -> depth pyramid -> late draw cull (every class, merged) -> late
cluster cull (+ visibility write-back) -> late setup -> raster -> shade
(both streams) -> G-buffer -> composite.  Setup, raster and shade run the
CUDA kernels on a GPU and their plain torch versions on the CPU; nothing
reads counts back to the host inside a frame.

`post_passes=1` renders the opaque class; `post_passes=2` adds the
alpha-test class (postPass 1), which the late pass culls together with
class 0 and rasterizes in one merged stream through the raster kernel's
alpha_test variant (class group (0, 1), frame.py:135-143, 367-429); a scene
with opacity masks runs the setup kernel's alpha variant.  `render_frame`
samples textures when given a table.  Not ported yet: bloom, shadows and
the transmission layer (post_passes=3).  Fragment ids: early records are
[0, tri_capacity), late records tri_capacity + [0, late_tri_capacity)
(frame.py:389).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..config import TILE_H, TILE_W
from ..utils import math3d

from ..ops import cull, pyramid, raster, raster_tile, setup, shade
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
    # draw classes: 1 = opaque only; 2 adds the alpha-test class
    post_passes: int = 1

    def __post_init__(self):
        if self.post_passes not in (1, 2):
            raise NotImplementedError("post_passes must be 1 or 2: the transmission layer (3) is not ported")

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
        alpha-test classes share one stream."""
        return ((0,),) if self.post_passes == 1 else ((0, 1),)

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


def _cluster_pass(scene, params, emit, lod, dvb, words, atlas, cfg, *, late, pyr_hw):
    """Cluster cull + screen-x order + setup metadata for one pass; the late
    pass culls every class of the frame and keeps the survivors of its one
    class group."""
    groups, new_words, n_draws, ddrop, cdrop, n_cand = cull.cluster_cull_direct_multi(
        scene, params, emit, lod, dvb, words, atlas, late=late, pyramid_shape=pyr_hw,
        draw_capacity=cfg.cmd_capacity,
        cluster_capacity=cfg.late_cluster_cap if late else cfg.cluster_capacity,
        candidate_capacity=cfg.late_candidate_cap if late else cfg.candidate_cap,
        num_classes=cfg.post_passes if late else 1, class_groups=cfg.late_class_groups if late else None,
    )
    ((cdraw, cmi, ccount),) = groups
    cdraw, cmi = raster.order_clusters_by_x(scene, params, cdraw, cmi, ccount)
    tc = raster.transform_meta_direct(scene, cdraw, cmi, ccount)
    return tc, ccount, new_words, n_draws, ddrop, cdrop, n_cand


def frame_core(scene, state: FrameState, params, cfg: FrameConfig, capture: dict | None = None):
    """Cull + raster + attribute resolve for one frame.  Returns (fb,
    new_state, stats, attrs [H,W,13]).  A `capture` dict receives the
    inputs of every kernel call (chip_smoke.py replays them against the
    plain versions)."""
    assert cfg.width % TILE_W == 0 and cfg.height % TILE_H == 0, "render size must be a multiple of (8,128)"
    dev = state.draw_vis.device
    levels, ph, pw = cfg.pyramid_levels_shape
    pyr_hw = (ph, pw)
    tiles_x, tiles_y = cfg.width // TILE_W, cfg.height // TILE_H
    raster_kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, class_caps=cfg.pair_class_caps)

    # early pass: last frame's visible draws and clusters
    empty_atlas = torch.zeros((levels, ph, pw), dtype=torch.float32, device=dev)
    emit_e, lod_e, _ = cull.draw_cull(scene, params, state.draw_vis, empty_atlas, late=False, pyramid_shape=pyr_hw)
    tc_e, ccount_e, _, ncmd_e, ddrop_e, cdrop_e, _ = _cluster_pass(
        scene, params, emit_e, lod_e, state.draw_vis, state.vis_words, empty_atlas, cfg, late=False, pyr_hw=pyr_hw)
    st_e = setup.setup_compact(tc_e, scene, params, cfg.width, cfg.height, cfg.tri_capacity)
    depth = torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=dev)
    vis = torch.full((cfg.height, cfg.width), INVALID_FRAG, dtype=torch.int32, device=dev)
    carry_e = (depth, vis)
    depth, vis, rst_e = raster_tile.rasterize_tiles(
        st_e, depth, vis, pair_capacity=cfg.pair_capacity, frag_offset=0, **raster_kw)

    # late pass: newly visible draws and clusters (and every visible draw of
    # the alpha class), occlusion-tested against the early depth, with the
    # visibility write-back
    atlas = pyramid.build_pyramid(depth, levels, ph, pw)
    emit_l, lod_l, new_draw_vis = cull.draw_cull(
        scene, params, state.draw_vis, atlas, late=True, pyramid_shape=pyr_hw, num_classes=cfg.post_passes)
    tc_l, ccount_l, new_words, ncmd_l, ddrop_l, cdrop_l, n_cand = _cluster_pass(
        scene, params, emit_l, lod_l, state.draw_vis, state.vis_words, atlas, cfg, late=True, pyr_hw=pyr_hw)
    st_l = setup.setup_compact(tc_l, scene, params, cfg.width, cfg.height, cfg.late_tri_cap)
    carry_l = (depth, vis)
    depth, vis, rst_l = raster_tile.rasterize_tiles(
        st_l, depth, vis, pair_capacity=cfg.late_pair_cap,
        frag_offset=cfg.tri_capacity, alpha_test=cfg.post_passes == 2, **raster_kw)

    attrs = raster_tile.shade_tiles([rst_e["stream"], rst_l["stream"]], vis)
    if capture is not None:
        capture.update(
            setup=[(tc_e, cfg.tri_capacity), (tc_l, cfg.late_tri_cap)],
            raster=[(rst["tile_start"], rst["pair_tri"], st["rec"], off, *carry)
                    for rst, st, off, carry in ((rst_e, st_e, 0, carry_e),
                                                (rst_l, st_l, cfg.tri_capacity, carry_l))],
            raster_alpha_test=(False, cfg.post_passes == 2),
            shade=([rst_e["stream"], rst_l["stream"]], vis),
        )
    new_state = FrameState(draw_vis=new_draw_vis.to(torch.int32), vis_words=new_words)
    stats = FrameStats(
        early_commands=ncmd_e,
        late_commands=ncmd_l,
        early_clusters=ccount_e,
        late_clusters=ccount_l,
        visible_draws=new_draw_vis.sum(),
        cmd_dropped=ddrop_e + ddrop_l,
        cluster_dropped=cdrop_e + cdrop_l,
        tri_dropped=st_e["dropped"] + st_l["dropped"],
        pair_dropped=rst_e["dropped"] + rst_l["dropped"],
        pair_drop_vec=rst_e["drop_vec"] + rst_l["drop_vec"],
        pair_demand_vec=rst_e["demand_vec"] + rst_l["demand_vec"],
        candidates=n_cand,
        tri_count=st_e["count"] + st_l["count"],
        pair_count=rst_e["pair_count"] + rst_l["pair_count"],
    )
    return Framebuffer(depth=depth, vis=vis), new_state, stats, attrs


def render_frame(scene, state: FrameState, params, shade_params: ShadeParams, cfg: FrameConfig,
                 textures=None, capture: dict | None = None):
    """Render one frame; `textures` (render.textures.TextureTable on the
    scene's device) textures the materials.  Returns (image [H,W,3], fb,
    new_state, stats)."""
    fb, new_state, stats, attrs = frame_core(scene, state, params, cfg, capture=capture)
    g0, g1, valid = shade.gbuffer_from_attrs(attrs, fb.vis != INVALID_FRAG, scene, textures=textures)
    image = shade.composite(
        g0, g1, fb.depth, valid,
        camera_position=shade_params.camera_position, sun_direction=shade_params.sun_direction,
        inverse_view_projection=shade_params.inverse_view_projection, width=cfg.width, height=cfg.height,
    )
    return image, fb, new_state, stats


def make_frame_inputs(camera: Camera, settings: RenderSettings, cfg: FrameConfig, sun_direction=None):
    """Host-side per-frame constants: (CullParams, ShadeParams) (frame.py:703)."""
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
