"""Two-pass draw and cluster culling (niagara_tpu/ops/cull.py, direct path).

`draw_cull` is the per-draw frustum/occlusion cull + LOD pick (:80), with
the late pass's merged multi-class form (`num_classes`);
`cluster_cull_direct_multi` (:397) expands emitted draws straight to a
flat cluster list, culls every cluster with the two-pass visibility-bit
protocol and the late pass's visibility-word write-back, and partitions
the survivors into class groups; `cluster_cull_direct` (:367) is its
single-class form.  `build_task_commands` (:158) is the legacy command
builder (64-meshlet task commands), which only the sun map still uses.

A frame's cull pass goes through `cull_draws` then `cull_clusters`: on
CPU tensors those are draw_cull, cluster_cull_direct_multi and each
group's raster.order_clusters_by_x + transform_meta_direct (the plain
twin, `cull_pass_plain` as one call); on CUDA tensors csrc/cull.cu's
draw_cull_kernel, cluster_cull_kernel, one torch.sort and one
cluster_order_kernel a class group (`cull_pass_cuda`), every output equal
bit for bit.

Visibility words are u32 values held in int64 (PyTorch's uint32 has few
ops); compacted lists keep the reference's prefix order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..config import TASK_WGSIZE
from . import compact, cullmath, raster


@dataclass
class TaskCommands:
    """Fixed-capacity task command buffer (cull.py:60); [capacity] int64
    fields, slots past `count` have task_count 0."""

    draw_id: torch.Tensor
    task_offset: torch.Tensor  # meshlet index of lane 0
    task_count: torch.Tensor  # live lanes (<= TASK_WGSIZE)
    late_draw_visibility: torch.Tensor
    vis_offset: torch.Tensor  # meshlet-visibility slot of lane 0
    count: torch.Tensor  # 0-d: live commands
    dropped: torch.Tensor  # 0-d: draws dropped whole on overflow


def build_task_commands(scene, emit, lod_index, draw_vis, *, capacity: int) -> TaskCommands:
    """Each emitted draw appends ceil(meshlets / 64) commands in draw-id
    order; a draw whose commands do not fit drops whole (cull.py:158-240,
    every field equal).  The slot of a draw is its prefix-sum position,
    and each command finds its owning draw by a cumulative max over the
    marks at the draws' first slots (cull.py:211-221)."""
    dev = emit.device
    pos = torch.arange(capacity, device=dev)
    e_draw, n_draws, over = compact.compact_mask_indices(emit, capacity)
    live_d = pos < n_draws
    e_lod = torch.clamp(lod_index[e_draw], 0, 15) * live_d
    e_vis = ((draw_vis[e_draw] != 0) & live_d).to(torch.int64)
    e_visoff = scene.draw_vis_offset[e_draw].to(torch.int64)
    meshlet_count = scene.draw_lod_meshlet_count[e_draw].gather(1, e_lod[:, None])[:, 0].to(torch.int64) * live_d
    meshlet_offset = scene.draw_lod_meshlet_offset[e_draw].gather(1, e_lod[:, None])[:, 0].to(torch.int64)

    groups = torch.where(live_d, (meshlet_count + TASK_WGSIZE - 1) // TASK_WGSIZE, 0)
    base = compact.exclusive_cumsum(groups)
    fits = base + groups <= capacity
    dropped = over + (live_d & ~fits).sum()
    groups = torch.where(fits, groups, 0)

    slot1 = torch.where(groups > 0, base, capacity)
    marks = compact.scatter_drop(torch.zeros(capacity, dtype=torch.int64, device=dev), slot1, pos + 1)
    start = torch.cummax(torch.where(marks > 0, pos, -1), 0).values
    started = start >= 0
    sp = torch.clamp_min(start, 0)
    ci = torch.where(started, marks[sp] - 1, 0)  # compacted draw index
    cg = torch.where(started, pos - sp, 0)  # command index within the draw
    c_count = torch.clamp(meshlet_count[ci] - cg * TASK_WGSIZE, 0, TASK_WGSIZE)
    live = started & (c_count > 0)
    return TaskCommands(
        draw_id=e_draw[ci],
        task_offset=meshlet_offset[ci] + cg * TASK_WGSIZE,
        task_count=torch.where(live, c_count, 0),
        late_draw_visibility=e_vis[ci] * live,
        vis_offset=e_visoff[ci] + cg * TASK_WGSIZE,
        count=groups.sum(),
        dropped=dropped,
    )


@dataclass
class CullParams:
    """Per-frame culling constants (cull.py:38).  Host values, like the
    reference's push constants: `view` is a numpy f32 [4,4], the rest are
    Python numbers holding exact f32 values (flags are ints)."""

    view: np.ndarray
    p00: float
    p11: float
    znear: float
    zfar: float
    frustum: np.ndarray  # f32 [4]
    lod_target: float
    pyramid_w: float
    pyramid_h: float
    culling_enabled: int
    lod_enabled: int
    occlusion_enabled: int
    cluster_occlusion_enabled: int
    cluster_backface_enabled: int
    post_pass: int


def transform_sphere_to_view(center_local, radius_local, orientation, scale, position, view):
    world = cullmath.rotate_quat(center_local, orientation) * scale[..., None] + position
    return cullmath.view_transform(world, view), radius_local * scale


def _occluded(center, radius, params: CullParams, atlas, pyramid_shape):
    """Sphere fully behind the depth pyramid (cull.py:115-120)."""
    valid, aabb = cullmath.project_sphere(center, radius, params.znear, params.p00, params.p11)
    level = cullmath.occlusion_mip(aabb, params.pyramid_w, params.pyramid_h)
    uv = torch.stack([(aabb[..., 0] + aabb[..., 2]) * 0.5, (aabb[..., 1] + aabb[..., 3]) * 0.5], dim=-1)
    depth = cullmath.sample_pyramid_min(atlas, uv, level, pyramid_shape[1], pyramid_shape[0])
    depth_sphere = cullmath.rdiv(params.znear, center[..., 2] - radius)
    return valid & (depth_sphere <= depth)


def draw_cull(scene, params: CullParams, draw_vis, atlas, *, late: bool, pyramid_shape,
              num_classes: int | None = None):
    """Per-draw cull + LOD select.  Returns (emit [D] bool, lod [D] int64,
    new draw visibility [D] bool).  Without `num_classes` it culls the
    draws of class params.post_pass; with it (late pass only) the draws of
    every class < num_classes in one pass, each draw keeping its own
    class's emission rule and visibility write-back (cull.py:105-138)."""
    row = scene.draw_mesh_row
    center, radius = transform_sphere_to_view(
        row[:, 0:3], row[:, 3], scene.draw_orientation, scene.draw_scale, scene.draw_position, params.view
    )
    if num_classes is None:
        in_pass = scene.draw_post_pass == params.post_pass
        pass_nonzero = params.post_pass != 0
    else:
        assert late, "merged multi-class culling is a late-pass protocol"
        in_pass = scene.draw_post_pass < num_classes
        pass_nonzero = scene.draw_post_pass != 0

    visible = cullmath.frustum_visible(center, radius, params.frustum, params.znear, params.zfar)
    visible = visible | (params.culling_enabled == 0)
    if late and params.occlusion_enabled:
        visible = visible & ~_occluded(center, radius, params, atlas, pyramid_shape)
    visible = visible & in_pass
    new_vis = torch.where(in_pass, visible, draw_vis != 0)

    if late:
        emit = visible & ((params.cluster_occlusion_enabled == 1) | (draw_vis == 0) | pass_nonzero)
    else:
        emit = visible & (draw_vis != 0)

    # LOD from screen-space error: highest i >= 1 with error < threshold
    dist = torch.clamp_min(torch.sqrt(cullmath.dot3(center, center)) - radius, 0.0)
    threshold = dist * params.lod_target / scene.draw_scale
    lod_count = row[:, 4].to(torch.int64)
    errors = row[:, 5:]
    idxs = torch.arange(errors.shape[1], device=errors.device)[None, :]
    passes = (errors < threshold[:, None]) & (idxs < lod_count[:, None]) & (idxs > 0)
    lod = torch.where(passes, idxs, 0).amax(dim=1)
    if not params.lod_enabled:
        lod = torch.zeros_like(lod)
    return emit, lod, new_vis


def cluster_cull_direct(scene, params: CullParams, emit, lod_index, draw_vis, vis_words, atlas, *,
                        late: bool, pyramid_shape, draw_capacity: int, cluster_capacity: int,
                        candidate_capacity: int | None = None):
    """Single-class cluster_cull_direct_multi: the draws of one post class,
    pre-filtered by draw_cull.

    Returns (cluster_draw [cap] int64, cluster_mi [cap] int64, count,
    new_vis_words, n_draws, draw_dropped, cluster_dropped, n_candidates);
    counts are 0-d int64 tensors."""
    groups, *rest = cluster_cull_direct_multi(
        scene, params, emit, lod_index, draw_vis, vis_words, atlas, late=late, pyramid_shape=pyramid_shape,
        draw_capacity=draw_capacity, cluster_capacity=cluster_capacity, candidate_capacity=candidate_capacity)
    return (*groups[0], *rest)


def cluster_cull_direct_multi(scene, params: CullParams, emit, lod_index, draw_vis, vis_words, atlas, *,
                              late: bool, pyramid_shape, draw_capacity: int, cluster_capacity,
                              candidate_capacity: int | None = None, num_classes: int = 1,
                              class_groups: tuple | None = None):
    """Draws -> candidate clusters -> per-cluster cull -> ordered survivors
    per class group (cull.py:397).

    With num_classes > 1, draws of every class expand and cull together
    (feed draw_cull(num_classes=...) emissions); the visibility skip and
    the backface cone cull apply to class-0 clusters only, occlusion and
    the write-back to all.  `class_groups` (default one group per class)
    partitions the survivors, draw-major within each group;
    `cluster_capacity` is an int or one capacity per group.

    Returns (per_group, new_vis_words, n_draws, draw_dropped,
    cluster_dropped, n_candidates), per_group a list of (cluster_draw [cap]
    int64, cluster_mi [cap] int64, count); counts are 0-d int64 tensors."""
    if class_groups is None:
        class_groups = tuple((c,) for c in range(num_classes))
    caps = (cluster_capacity,) * len(class_groups) if isinstance(cluster_capacity, int) else tuple(cluster_capacity)
    assert len(caps) == len(class_groups)
    if candidate_capacity is None:
        candidate_capacity = max(caps)
    dev = emit.device

    # 1) emitted draws, ascending id
    e_draw, n_draws, over_d = compact.compact_mask_indices(emit, draw_capacity)
    pos_d = torch.arange(draw_capacity, device=dev)
    live_d = pos_d < n_draws
    e_lod = torch.clamp(lod_index[e_draw], 0, 15) * live_d
    e_vis = (draw_vis[e_draw] != 0) & live_d
    e_visoff = scene.draw_vis_offset[e_draw].to(torch.int64)
    meshlet_count = scene.draw_lod_meshlet_count[e_draw].gather(1, e_lod[:, None])[:, 0].to(torch.int64) * live_d
    meshlet_offset = scene.draw_lod_meshlet_offset[e_draw].gather(1, e_lod[:, None])[:, 0].to(torch.int64)

    # 2) expand draws -> candidate clusters (draw-major, meshlet ordinal
    # within the draw); draws whose clusters do not fit drop whole
    base = compact.exclusive_cumsum(meshlet_count)
    fits = base + meshlet_count <= candidate_capacity
    draw_dropped = over_d + (live_d & (meshlet_count > 0) & ~fits).sum()
    mcount = torch.where(fits, meshlet_count, 0)
    slot1 = torch.where(mcount > 0, base, candidate_capacity)
    marks = compact.scatter_drop(torch.zeros(candidate_capacity, dtype=torch.int64, device=dev), slot1, pos_d + 1)
    kpos = torch.arange(candidate_capacity, device=dev)
    start_pos = torch.cummax(torch.where(marks > 0, kpos, -1), 0).values
    started = start_pos >= 0
    sp = torch.clamp_min(start_pos, 0)
    ci = torch.where(started, marks[sp] - 1, 0)  # compacted draw index
    ordv = kpos - sp

    valid = started & (ordv < mcount[ci])
    draw_id = e_draw[ci]
    mi = torch.clamp(meshlet_offset[ci] + ordv, 0, scene.meshlet_cull_row.shape[0] - 1)
    vis_slot = e_visoff[ci] + ordv
    multi = num_classes > 1
    cls = (scene.draw_post_pass[e_draw] * live_d)[ci] if multi else None

    # 3) per-cluster cull
    row = scene.meshlet_cull_row[mi]
    xf = scene.draw_xform_row[draw_id]
    scale = xf[:, 3]
    orientation = xf[:, 4:8]
    radius = row[:, 3] * scale
    world = cullmath.rotate_quat(row[:, 0:3], orientation) * scale[:, None] + xf[:, 0:3]
    center = cullmath.view_transform(world, params.view)
    cone_axis = cullmath.view_transform(cullmath.rotate_quat(row[:, 4:7], orientation), params.view, translate=False)

    words = vis_words[torch.clamp(vis_slot >> 5, 0, vis_words.shape[0] - 1)]
    bit = torch.ones_like(vis_slot) << (vis_slot & 31)
    vis_bit = (words & bit) != 0

    # the visibility skip and the backface cone cull gate on class 0 (post
    # classes render double-sided): per cluster when merged, else per pass
    cluster_occ = params.cluster_occlusion_enabled == 1
    if multi:
        cls0 = cls == 0
    else:
        cls0 = torch.ones_like(valid) if params.post_pass == 0 else torch.zeros_like(valid)
    visible = valid
    skip = torch.zeros_like(valid)
    if cluster_occ:
        if not late:
            visible = visible & (vis_bit | ~cls0)
        else:
            skip = cls0 & e_vis[ci] & vis_bit & valid

    if params.cluster_backface_enabled == 1:
        visible = visible & ~(cls0 & cullmath.cone_cull(center, radius, cone_axis, row[:, 7]))
    visible = visible & cullmath.frustum_visible(center, radius, params.frustum, params.znear, params.zfar)
    if late and cluster_occ:
        visible = visible & ~_occluded(center, radius, params, atlas, pyramid_shape)

    # late write-back: clear both words of every touched 64-slot pair,
    # then add the visible bits (cull.py:625-634)
    new_vis_words = vis_words
    if late and cluster_occ:
        W = vis_words.shape[0]
        w_lo = torch.where(valid, (vis_slot >> 6) * 2, W)
        cleared = compact.scatter_drop(vis_words, w_lo, 0)
        cleared = compact.scatter_drop(cleared, torch.where(valid, w_lo + 1, W), 0)
        new_vis_words = compact.scatter_drop(
            cleared, torch.where(valid, vis_slot >> 5, W), torch.where(valid & visible, bit, 0), mode="add"
        )

    # 4) survivors per group, draw-major
    emit_mask = visible & ~skip
    per_group, cluster_dropped = [], 0
    for group, cap in zip(class_groups, caps):
        mask = emit_mask
        if multi:
            in_group = cls == group[0]
            for c in group[1:]:
                in_group = in_group | (cls == c)
            mask = mask & in_group
        idx, k_count, over = compact.compact_mask_indices(mask, cap)
        per_group.append((draw_id[idx], mi[idx], k_count))
        cluster_dropped = cluster_dropped + over
    return per_group, new_vis_words, n_draws, draw_dropped, cluster_dropped, mcount.sum()


@dataclass
class DrawList:
    """One cull pass's draw stage (`cull_draws`): `emit`, `lod` and
    `new_vis` [D] as draw_cull returns them, the pass's inputs for its
    cluster stage, and on the kernel route (`kernel`, else None) the
    compacted draws, the counters and the write-back's words."""

    emit: torch.Tensor
    lod: torch.Tensor
    new_vis: torch.Tensor
    inputs: dict
    kernel: dict | None = None


def cull_draws(scene, params: CullParams, draw_vis, vis_words, atlas, *, late: bool, pyramid_shape,
               draw_capacity: int, candidate_capacity: int, num_classes: int | None = None) -> DrawList:
    """A cull pass's draw stage: draw_cull (num_classes as there; the
    early pass passes no atlas) on CPU tensors, draw_cull_cuda on CUDA
    tensors.  `vis_words` and the capacities are the cluster stage's."""
    stage = draw_stage_plain if draw_vis.device.type == "cpu" else draw_cull_cuda
    return stage(scene, params, draw_vis, vis_words, atlas, late=late, pyramid_shape=pyramid_shape,
                 draw_capacity=draw_capacity, candidate_capacity=candidate_capacity, num_classes=num_classes)


def draw_stage_plain(scene, params: CullParams, draw_vis, vis_words, atlas, **kw) -> DrawList:
    """cull_draws in plain torch on any device (draw_cull_cuda's twin)."""
    return DrawList(*draw_cull(scene, params, draw_vis, atlas, late=kw["late"], pyramid_shape=kw["pyramid_shape"],
                               num_classes=kw["num_classes"]),
                    dict(kw, draw_vis=draw_vis, vis_words=vis_words, atlas=atlas))


def cull_clusters(scene, params: CullParams, drawn: DrawList, *, cluster_capacity, class_groups: tuple | None = None):
    """A cull pass's cluster stage on `drawn`: the clusters of the emitted
    draws culled (merged over the draw stage's classes when it had more
    than one), the survivors of each class group in screen-x order with
    their setup metadata.  Returns ([(tc, count)] a group: tc
    raster.transform_meta_direct's dict, count 0-d int64), new_vis_words,
    n_draws, draw_dropped, cluster_dropped, n_candidates -- the counts of
    cluster_cull_direct_multi."""
    if drawn.kernel is not None:
        return cluster_cull_cuda(scene, params, drawn, cluster_capacity=cluster_capacity, class_groups=class_groups)
    i = drawn.inputs
    groups, *rest = cluster_cull_direct_multi(
        scene, params, drawn.emit, drawn.lod, i["draw_vis"], i["vis_words"], i["atlas"], late=i["late"],
        pyramid_shape=i["pyramid_shape"], draw_capacity=i["draw_capacity"], cluster_capacity=cluster_capacity,
        candidate_capacity=i["candidate_capacity"], num_classes=i["num_classes"] or 1, class_groups=class_groups)
    out = []
    for cdraw, cmi, ccount in groups:
        cdraw, cmi = raster.order_clusters_by_x(scene, params, cdraw, cmi, ccount)
        out.append((raster.transform_meta_direct(scene, cdraw, cmi, ccount), ccount))
    return (out, *rest)


def _pass(draws, clusters, scene, params, draw_vis, vis_words, atlas, *, late, pyramid_shape, draw_capacity,
          candidate_capacity, cluster_capacity, num_classes=None, class_groups=None) -> dict:
    drawn = draws(scene, params, draw_vis, vis_words, atlas, late=late, pyramid_shape=pyramid_shape,
                  draw_capacity=draw_capacity, candidate_capacity=candidate_capacity, num_classes=num_classes)
    groups, new_words, n_draws, ddrop, cdrop, n_cand = clusters(scene, params, drawn, cluster_capacity=cluster_capacity,
                                                                class_groups=class_groups)
    return dict(emit=drawn.emit, lod=drawn.lod, new_vis=drawn.new_vis, groups=[tc for tc, _ in groups],
                counts=[c for _, c in groups], new_vis_words=new_words, n_draws=n_draws, draw_dropped=ddrop,
                cluster_dropped=cdrop, n_candidates=n_cand)


def cull_pass_plain(scene, params: CullParams, draw_vis, vis_words, atlas, **kw) -> dict:
    """One cull pass (cull_draws then cull_clusters, their keywords) in
    plain torch on any device: dict(emit, lod, new_vis, groups (each
    group's tc), counts, new_vis_words, n_draws, draw_dropped,
    cluster_dropped, n_candidates).  cull_pass_cuda's plain twin."""
    return _pass(draw_stage_plain, cull_clusters, scene, params, draw_vis, vis_words, atlas, **kw)


def cull_pass_cuda(scene, params: CullParams, draw_vis, vis_words, atlas, **kw) -> dict:
    """cull_pass_plain through csrc/cull.cu's kernels."""
    _class_groups(kw.get("num_classes") or 1, kw["cluster_capacity"], kw.get("class_groups"))
    return _pass(draw_cull_cuda, cluster_cull_cuda, scene, params, draw_vis, vis_words, atlas, **kw)


def _expect(t, dtype, shape: tuple, what: str) -> None:
    """Raise unless `t` has `dtype` and `shape` (None: any size there);
    the device is checked after."""
    if t.dtype != dtype or t.dim() != len(shape) or any(n is not None and n != m for n, m in zip(shape, t.shape)):
        raise ValueError(f"{what}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")


def _consts(params: CullParams) -> _build.CullConsts:
    v = params.view
    c = _build.CullConsts(p00=params.p00, p11=params.p11, znear=params.znear, zfar=params.zfar,
                          lod_target=params.lod_target, pyramid_w=params.pyramid_w, pyramid_h=params.pyramid_h,
                          culling=int(params.culling_enabled), lod=int(params.lod_enabled),
                          occlusion=int(params.occlusion_enabled),
                          cluster_occlusion=int(params.cluster_occlusion_enabled),
                          cluster_backface=int(params.cluster_backface_enabled), post_pass=int(params.post_pass))
    c.view[:] = [float(v[i, j]) for i in range(3) for j in range(4)]
    c.frustum[:] = [float(x) for x in params.frustum]
    return c


def _atlas_args(atlas, pyramid_shape, needed: bool):
    """(pointer, elements, base height, base width) of the atlas a late
    pass reads; nothing when the pass reads none."""
    if not needed:
        return None, 0, 0, 0
    _build.expect(atlas, torch.float32, tuple(pyramid_shape), "cull atlas")
    atlas = atlas.contiguous()
    return atlas.data_ptr(), atlas.numel(), int(pyramid_shape[0]), int(pyramid_shape[1])


_MAX_COUNT = (1 << 30) - 1  # the look-back's 30-bit counts


def _class_groups(num_classes: int, cluster_capacity, class_groups):
    """(class groups, a capacity each) as cluster_cull_direct_multi reads
    them; ValueError where the kernel cannot take them."""
    if class_groups is None:
        class_groups = tuple((c,) for c in range(num_classes))
    caps = (cluster_capacity,) * len(class_groups) if isinstance(cluster_capacity, int) else tuple(cluster_capacity)
    if not 1 <= len(class_groups) <= _build.CULL_GROUPS or len(caps) != len(class_groups):
        raise ValueError(f"cluster_cull: {len(class_groups)} class groups, {len(caps)} capacities (1 to "
                         f"{_build.CULL_GROUPS} groups, one capacity each)")
    if any(not 0 <= c < _build.CULL_CLASSES for g in class_groups for c in g):
        raise ValueError(f"cluster_cull: class groups {class_groups} (classes 0 to {_build.CULL_CLASSES - 1})")
    if any(not 1 <= cap <= _MAX_COUNT for cap in caps):
        raise ValueError(f"cluster_cull: cluster capacities {caps} must lie in [1, 2^30)")
    return class_groups, caps


def draw_cull_cuda(scene, params: CullParams, draw_vis, vis_words, atlas, *, late: bool, pyramid_shape,
                   draw_capacity: int, candidate_capacity: int, num_classes: int | None = None) -> DrawList:
    """csrc/cull.cu's draw_cull_kernel: draw_cull's emit, lod and new_vis,
    and for cluster_cull_cuda the emitted draws compacted in id order with
    their candidate prefix, the counters (n_draws, draw_dropped,
    n_candidates), and with the late write-back a copy of the words with
    every touched 64-slot pair cleared."""
    D = scene.num_draws
    if not 1 <= draw_capacity <= _MAX_COUNT or not 1 <= candidate_capacity <= _MAX_COUNT:
        raise ValueError(f"draw_cull: capacities {draw_capacity} / {candidate_capacity} must lie in [1, 2^30)")
    if not 1 <= D < 1 << 26:
        raise ValueError(f"draw_cull: {D} draws (the kernel's counts take 1 to 2^26 - 1)")
    if num_classes is not None and not (late and 1 <= num_classes <= _build.CULL_CLASSES):
        raise ValueError(f"draw_cull: num_classes {num_classes} (a late pass's, 1 to {_build.CULL_CLASSES})")
    _expect(draw_vis, torch.int32, (D,), "draw_cull draw_vis")
    _expect(vis_words, torch.int64, (None,), "draw_cull vis_words")
    _build.require_cuda(draw_vis, "draw_cull")
    vis_words = vis_words.contiguous()
    nl = scene.draw_lod_meshlet_count.shape[1]
    mesh_row = scene.draw_mesh_row.contiguous()
    _build.expect(mesh_row, torch.float32, (D, 5 + nl), "draw_mesh_row")
    fields = [(scene.draw_orientation, torch.float32, (D, 4)), (scene.draw_scale, torch.float32, (D,)),
              (scene.draw_position, torch.float32, (D, 3)), (scene.draw_post_pass, torch.int32, (D,)),
              (draw_vis, torch.int32, (D,)), (scene.draw_lod_meshlet_count, torch.int32, (D, nl)),
              (scene.draw_lod_meshlet_offset, torch.int32, (D, nl)), (scene.draw_vis_offset, torch.int32, (D,))]
    ts = []
    for t, dtype, shape in fields:
        _build.expect(t, dtype, shape, "draw_cull input")
        ts.append(t.contiguous())
    orient, scale, pos, post, dvb, lod_count, lod_offset, visoff = ts
    write_back = late and params.cluster_occlusion_enabled == 1
    atlas_args = _atlas_args(atlas, pyramid_shape, late and (bool(params.occlusion_enabled) or write_back))
    dev = draw_vis.device
    n_tiles = -(-D // _build.CULL_TILE)
    n_cluster_tiles = -(-candidate_capacity // _build.CULL_TILE)
    # one zeroed buffer: 10 counters, the draw tiles' status, the two
    # kernels' tickets, the cluster tiles' status (u32, CULL_GROUPS a tile)
    scratch = torch.zeros(12 + n_tiles + -(-_build.CULL_GROUPS * n_cluster_tiles // 2), dtype=torch.int64, device=dev)
    emit = torch.empty(D, dtype=torch.bool, device=dev)
    lod = torch.empty(D, dtype=torch.int64, device=dev)
    new_vis = torch.empty(D, dtype=torch.bool, device=dev)
    bases = torch.empty(draw_capacity, dtype=torch.int32, device=dev)
    entries = torch.empty((draw_capacity, 6), dtype=torch.int32, device=dev)
    new_words = vis_words.clone() if write_back else vis_words
    sp = scratch.data_ptr()
    rc = _build.lib().draw_cull_launch(
        mesh_row.data_ptr(), mesh_row.shape[1], orient.data_ptr(), scale.data_ptr(), pos.data_ptr(),
        post.data_ptr(), dvb.data_ptr(), lod_count.data_ptr(), lod_offset.data_ptr(), nl, visoff.data_ptr(), D,
        *atlas_args, _consts(params), int(late), num_classes or 0, draw_capacity, candidate_capacity,
        emit.data_ptr(), lod.data_ptr(), new_vis.data_ptr(), bases.data_ptr(), entries.data_ptr(),
        new_words.data_ptr() if write_back else None, vis_words.shape[0], sp, sp + 8 * 10, sp + 8 * (10 + n_tiles),
        _build.stream_ptr(draw_vis))
    _build.LAUNCHES["draw_cull"] += 1
    _build.check(rc, "draw_cull")
    inputs = dict(draw_vis=draw_vis, vis_words=vis_words, atlas=atlas, late=late, pyramid_shape=pyramid_shape,
                  draw_capacity=draw_capacity, candidate_capacity=candidate_capacity, num_classes=num_classes)
    kernel = dict(scratch=scratch, bases=bases, entries=entries, new_words=new_words, write_back=write_back,
                  atlas_args=atlas_args, lod_offset=lod_offset, n_tiles=n_tiles, n_cluster_tiles=n_cluster_tiles)
    return DrawList(emit, lod, new_vis, inputs, kernel)


def cluster_cull_cuda(scene, params: CullParams, drawn: DrawList, *, cluster_capacity,
                      class_groups: tuple | None = None):
    """csrc/cull.cu's cluster_cull_kernel on draw_cull_cuda's compacted
    draws, then per class group torch.sort of its x-order keys and
    cluster_order_kernel: cull_clusters' contract."""
    if drawn.kernel is None:
        raise ValueError("cluster_cull_cuda: the draw stage did not run on the kernel route")
    i, k = drawn.inputs, drawn.kernel
    num_classes = i["num_classes"] or 1
    class_groups, caps = _class_groups(num_classes, cluster_capacity, class_groups)
    _build.require_cuda(scene.draw_xform_row, "cluster_cull")
    M, D = scene.meshlet_cull_row.shape[0], scene.num_draws
    xform = scene.draw_xform_row.contiguous()
    _build.expect(scene.meshlet_cull_row, torch.float32, (M, 8), "meshlet_cull_row")
    _build.expect(xform, torch.float32, (D, 8), "draw_xform_row")
    if xform.data_ptr() % 16:  # rows are copied with 16-byte loads
        xform = xform.clone()
    cull_row = scene.meshlet_cull_row.contiguous()
    dev = xform.device
    sp = k["scratch"].data_ptr()
    counters = k["scratch"][:10]
    gs = _build.GroupSpec(n=len(class_groups))
    keys, draws, mis = [], [], []
    for g, (group, cap) in enumerate(zip(class_groups, caps)):
        slot_bits = max(cap - 1, 1).bit_length()
        half = float(1 << (31 - slot_bits - 1))
        keys.append(torch.empty(cap, dtype=torch.int32, device=dev))
        draws.append(torch.empty(cap, dtype=torch.int32, device=dev))
        mis.append(torch.empty(cap, dtype=torch.int32, device=dev))
        gs.cap[g], gs.slot_bits[g], gs.half[g], gs.hi[g] = cap, slot_bits, half, 2.0 * half - 1.0
        gs.key[g], gs.draw[g], gs.mi[g] = keys[g].data_ptr(), draws[g].data_ptr(), mis[g].data_ptr()
        for c in group:
            gs.group_mask[c] |= 1 << g
    words = i["vis_words"]
    rc = _build.lib().cluster_cull_launch(
        k["bases"].data_ptr(), k["entries"].data_ptr(), k["lod_offset"].data_ptr(), cull_row.data_ptr(), M,
        xform.data_ptr(), words.data_ptr(), words.shape[0],
        k["new_words"].data_ptr() if k["write_back"] else None, *k["atlas_args"], _consts(params), int(i["late"]),
        int(num_classes > 1), i["candidate_capacity"], gs, sp, sp + 8 * (12 + k["n_tiles"]),
        sp + 8 * (11 + k["n_tiles"]), _build.stream_ptr(xform))
    _build.LAUNCHES["cluster_cull"] += 1
    _build.check(rc, "cluster_cull")

    tri_count, mat, post = scene.meshlet_triangle_count, scene.draw_material_index, scene.draw_post_pass
    for t, what in ((tri_count, "meshlet_triangle_count"), (mat, "draw_material_index"), (post, "draw_post_pass")):
        _build.expect(t, torch.int32, (t.shape[0],), what)
    groups = []
    for g, cap in enumerate(caps):
        ordered = torch.sort(keys[g]).values
        out = dict(mi=torch.empty(cap, dtype=torch.int64, device=dev),
                   tri_count=torch.empty(cap, dtype=torch.int32, device=dev),
                   xform=torch.empty((cap, 8), dtype=torch.float32, device=dev),
                   draw_id=torch.empty(cap, dtype=torch.int64, device=dev),
                   mat_index=torch.empty(cap, dtype=torch.int32, device=dev),
                   post_pass=torch.empty(cap, dtype=torch.int32, device=dev))
        rc = _build.lib().cluster_order_launch(
            ordered.data_ptr(), draws[g].data_ptr(), mis[g].data_ptr(), sp, g, cap, gs.slot_bits[g],
            tri_count.contiguous().data_ptr(), tri_count.shape[0], xform.data_ptr(), mat.contiguous().data_ptr(),
            post.contiguous().data_ptr(), *(t.data_ptr() for t in out.values()), _build.stream_ptr(xform))
        _build.LAUNCHES["cluster_order"] += 1
        _build.check(rc, "cluster_order")
        count = counters[4 + g]
        out["count"] = count.reshape(1)
        if scene.has_alpha_masks:
            out["alpha"] = scene.meshlet_alpha
        groups.append((out, count))
    return groups, k["new_words"], counters[0], counters[1], counters[3], counters[2]
