"""Two-pass draw and cluster culling (niagara_tpu/ops/cull.py, direct path).

`draw_cull` is the per-draw frustum/occlusion cull + LOD pick (:80), with
the late pass's merged multi-class form (`num_classes`);
`cluster_cull_direct_multi` (:397) expands emitted draws straight to a
flat cluster list, culls every cluster with the two-pass visibility-bit
protocol and the late pass's visibility-word write-back, and partitions
the survivors into class groups; `cluster_cull_direct` (:367) is its
single-class form.

Visibility words are u32 values held in int64 (PyTorch's uint32 has few
ops); compacted lists keep the reference's prefix order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import compact, cullmath


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
