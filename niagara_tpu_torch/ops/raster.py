"""Cluster ordering and per-cluster setup metadata (niagara_tpu/ops/raster.py).

`order_clusters_by_x` (:190) sorts surviving clusters by projected screen
x; `transform_meta_direct` (:242) gathers what the setup kernel reads per
cluster.  Keys are the reference's u32 values held in int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import cullmath

INVALID_FRAG = 0x7FFFFFFF  # vis value of a pixel no fragment covers


@dataclass
class Framebuffer:
    depth: torch.Tensor  # f32 [H,W], reverse-Z (0 = clear)
    vis: torch.Tensor  # i32 [H,W], fragment id or INVALID_FRAG


def order_clusters_by_x(scene, params, cluster_draw, cluster_mi, cluster_count):
    """Reorder clusters by projected screen-x center; dead tail slots sort
    after every live one.  Fragment ids follow this order, so it matches
    the reference's key (xq << slot_bits | slot) exactly."""
    K = cluster_draw.shape[0]
    dev = cluster_draw.device
    slot_bits = max(K - 1, 1).bit_length()
    xq_bits = 31 - slot_bits
    k = torch.arange(K, device=dev)
    live = k < cluster_count

    xf = scene.draw_xform_row[cluster_draw]
    mrow = scene.meshlet_cull_row[torch.clamp(cluster_mi, 0, scene.meshlet_cull_row.shape[0] - 1)]
    world = cullmath.rotate_quat(mrow[:, 0:3], xf[:, 4:8]) * xf[:, 3:4] + xf[:, 0:3]
    v = params.view
    camx = world[:, 0] * float(v[0, 0]) + world[:, 1] * float(v[0, 1]) + world[:, 2] * float(v[0, 2]) + float(v[0, 3])
    viewz = world[:, 0] * float(v[2, 0]) + world[:, 1] * float(v[2, 1]) + world[:, 2] * float(v[2, 2]) + float(v[2, 3])
    ratio = camx / torch.clamp_min(viewz, 1e-3)
    half = float(1 << (xq_bits - 1))
    xq = torch.clamp(ratio * 256.0 + half, 0.0, 2.0 * half - 1.0).to(torch.int64)
    key = torch.where(live, (xq << slot_bits) | k, (1 << 31) | k)
    idx = torch.sort(key).values & ((1 << slot_bits) - 1)
    return cluster_draw[idx], cluster_mi[idx]


def transform_meta_direct(scene, cluster_draw, cluster_mi, cluster_count):
    """Per-cluster setup inputs: meshlet index, triangle count, transform
    row and ids (the reference's dict minus the TPU row-table handles),
    plus the scene's opacity-mask table under "alpha" when it has masks
    (raster.py:257-258), which selects the setup kernel's alpha variant."""
    mi = torch.clamp(cluster_mi, 0, scene.meshlet_tris.shape[0] - 1)
    out = dict(
        mi=mi,
        tri_count=scene.meshlet_triangle_count[mi],
        xform=scene.draw_xform_row[cluster_draw],
        draw_id=cluster_draw,
        mat_index=scene.draw_material_index[cluster_draw],
        post_pass=scene.draw_post_pass[cluster_draw],
        count=torch.reshape(cluster_count, (1,)),
    )
    if scene.has_alpha_masks:
        out["alpha"] = scene.meshlet_alpha
    return out
