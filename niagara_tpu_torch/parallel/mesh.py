"""Multi-device rendering: draw-sharded frames with sort-last compositing
(niagara_tpu/parallel/mesh.py).

Each shard owns a round-robin slice of the draws, with its own
visibility state, and runs the whole cull -> setup -> raster -> shade
cascade for them at full resolution (render/frame.py::frame_core), its
fragment ids offset by `shard * frag_stride(cfg)` so that every
(shard, fragment) id is unique.  The framebuffers merge sort-last: the
max of reverse-Z depth, then the min of fragment id among the
exact-depth winners.  Each shard builds the G-buffer of the pixels it
owns (at an owned pixel its local winner is the global one), packs it
into two i32 planes (ops/shade.py::pack_gbuffer; every other pixel packs
to 0) and the planes are summed: a union, bit for bit.  Bloom, the
sun-map shadow term and the composite then run once on the merged planes
(the reference runs them replicated on every device).

The reductions go through a collective object with `max`, `min` and
`sum` over the shards:
* `InProcess`: this process holds every shard (all on one device) and
  reduces by stacking -- the counterpart of XLA's virtual mesh, and how
  one card renders N shards;
* `Distributed`: one shard per torch.distributed rank, `all_reduce` where
  the tensors live (gloo on the CPU or with ranks sharing a card, whose
  CUDA tensors gloo reduces with MAX, MIN and SUM; NCCL with one card a
  rank).
Both run the same per-shard code, and max, min and a sum of disjoint
planes are exact, so the result does not depend on the collective.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import scene as scene_mod
from ..ops import shade
from ..ops.raster import INVALID_FRAG, Framebuffer
from ..render import frame as frame_mod


class InProcess:
    """Every shard in this process, on one device: a collective is a
    reduction over the stacked shards."""

    def shard_ids(self, n_local: int) -> list[int]:
        return list(range(n_local))

    def max(self, xs):
        return torch.stack(xs).amax(0)

    def min(self, xs):
        return torch.stack(xs).amin(0)

    def sum(self, xs):
        return torch.stack(xs).sum(0).to(xs[0].dtype)


class Distributed:
    """One shard per rank of a torch.distributed group (the default group
    when `group` is None): each collective is one all_reduce of a copy of
    this rank's tensor, where it lives."""

    def __init__(self, group=None):
        self.group = group

    def shard_ids(self, n_local: int) -> list[int]:
        if n_local != 1:
            raise ValueError(f"Distributed: each rank holds one shard, got {n_local}")
        return [torch.distributed.get_rank(self.group)]

    def _reduce(self, xs, op):
        (x,) = xs
        y = x.clone()
        torch.distributed.all_reduce(y, op=op, group=self.group)
        return y

    def max(self, xs):
        return self._reduce(xs, torch.distributed.ReduceOp.MAX)

    def min(self, xs):
        return self._reduce(xs, torch.distributed.ReduceOp.MIN)

    def sum(self, xs):
        return self._reduce(xs, torch.distributed.ReduceOp.SUM)


def shard_draws(geometry, draws, n_shards: int, materials=None, device="cuda") -> list:
    """One DeviceScene on `device` per shard of a round-robin split of the
    draws (shard s takes draws s, s + n, ...; mesh.py:38), each uploaded
    with its own visibility offsets and `materials` only, as the reference
    does: no opacity masks and no texture table (the textures themselves
    go to the frame).  Every shard's meshlet_visibility_count is the
    largest one, so all states have one size.  The reference stacks the
    shards, so they must be equal: `draws.count` a multiple of n_shards."""
    if n_shards < 1 or draws.count % n_shards:
        raise ValueError(f"shard_draws: {draws.count} draws do not split into {n_shards} equal shards")
    layouts = []
    for s in range(n_shards):
        shard = scene_mod.Draws(**{f.name: getattr(draws, f.name)[s::n_shards].copy()
                                   for f in dataclasses.fields(scene_mod.Draws)})
        layouts.append(scene_mod.upload(geometry, shard, materials))
    vis_count = max(d.meshlet_visibility_count for d in layouts)
    return [scene_mod.from_numpy(dataclasses.replace(d, meshlet_visibility_count=vis_count), device)
            for d in layouts]


def init_sharded_state(scenes) -> list:
    """Each shard's cleared FrameState, on its scene's device (mesh.py:63)."""
    return [frame_mod.init_state(sc.num_draws, sc.meshlet_visibility_count, sc.draw_scale.device) for sc in scenes]


def frag_stride(cfg) -> int:
    """Fragment ids a shard reserves (mesh.py:92): the early pass's
    tri_capacity plus one late_tri_capacity block per late group or post
    pass, whichever is more -- the reference's formula, which also covers
    its legacy path, kept so that the ids, and so the cross-shard
    tie-break, equal the reference's."""
    return cfg.tri_capacity + max(len(cfg.late_class_groups), cfg.post_passes) * cfg.late_tri_cap


def sort_last(depths, viss, coll):
    """Merge the shards' framebuffers (mesh.py:107-112): the global depth
    (max of reverse-Z), the global winner (min id among the exact-depth
    winners) and each shard's owner mask.  Returns (gdepth, gvis, mine)."""
    gdepth = coll.max(depths)
    winners = [(d == gdepth) & (v != INVALID_FRAG) for d, v in zip(depths, viss)]
    gvis = coll.min([torch.where(w, v, INVALID_FRAG) for w, v in zip(winners, viss)])
    return gdepth, gvis, [w & (gvis == v) for w, v in zip(winners, viss)]


def merge_gbuffer(attrs, mine, scenes, coll, depth, inverse_view_projection, textures=None):
    """Each shard's G-buffer of the pixels it owns, packed, summed over the
    shards and unpacked (mesh.py:122-141).  Returns (g0, g1, valid)."""
    packed = [shade.pack_gbuffer(*shade.gbuffer_from_attrs(a, m, sc, textures=textures, depth=depth,
                                                           inverse_view_projection=inverse_view_projection))
              for a, m, sc in zip(attrs, mine, scenes)]
    return shade.unpack_gbuffer(coll.sum([p[0] for p in packed]), coll.sum([p[1] for p in packed]))


def _sum_stats(stats, coll) -> frame_mod.FrameStats:
    """FrameStats summed over the shards in one reduction (mesh.py:206)."""
    names = [f.name for f in dataclasses.fields(frame_mod.FrameStats)]
    shapes = [getattr(stats[0], n).shape for n in names]
    flat = coll.sum([torch.cat([getattr(s, n).reshape(-1).to(torch.int64) for n in names]) for s in stats])
    parts = torch.split(flat, [sh.numel() for sh in shapes])
    return frame_mod.FrameStats(**{n: p.reshape(sh) for n, p, sh in zip(names, parts, shapes)})


def render_sharded_frame(scenes, states, params, shade_params, cfg, coll, textures=None, sun=None,
                         capture: dict | None = None):
    """One sharded frame (make_sharded_frame, mesh.py:69-222) of the
    shards this process holds (`scenes`, `states`: all of them under
    InProcess, this rank's one under Distributed).  `textures` and `sun`
    (the packed sun-map 3-tuple, render_frame's `sun`) are replicated
    inputs.  `capture` receives each local shard's frame_core capture
    ("shards"), id ("shard_ids"), framebuffer ("fbs"), attribute planes
    ("attrs") and owner mask ("mine"), the merged valid mask ("valid"),
    G-buffer ("g0", "g1") and shadow term ("shadow") and, with
    post_passes=3, the merged layer ("layer": depth, vis, valid).
    Returns (image [H,W,3], Framebuffer(gdepth, gvis), the local shards'
    new states, stats summed over all shards)."""
    stride = frag_stride(cfg)
    ids = coll.shard_ids(len(scenes))
    caps = [{} if capture is not None else None for _ in scenes]
    outs = [frame_mod.frame_core(sc, st, params, cfg, capture=cp, frag_offset=i * stride)
            for sc, st, cp, i in zip(scenes, states, caps, ids)]
    ivp = shade_params.inverse_view_projection
    gdepth, gvis, mine = sort_last([o[0].depth for o in outs], [o[0].vis for o in outs], coll)
    g0, g1, valid = merge_gbuffer([o[3] for o in outs], mine, scenes, coll, gdepth, ivp, textures)

    # the transmission layer's own merge: the front-most transmission
    # fragment over all shards, shaded by its owner (mesh.py:146-161)
    transmission = layer = None
    if outs[0][4] is not None:
        layers = [o[4] for o in outs]
        t_depth, t_vis, t_mine = sort_last([lay["depth"] for lay in layers], [lay["vis"] for lay in layers], coll)
        g0t, g1t, t_valid = merge_gbuffer([lay["attrs"] for lay in layers], t_mine, scenes, coll, t_depth, ivp,
                                          textures)
        transmission = (g0t, g1t, t_depth, t_valid)
        layer = dict(depth=t_depth, vis=t_vis, valid=t_valid)
    if capture is not None:
        capture.update(shards=caps, shard_ids=ids, fbs=[o[0] for o in outs], attrs=[o[3] for o in outs], mine=mine,
                       valid=valid, g0=g0, g1=g1, layer=layer)
    image = frame_mod.composite_frame(g0, g1, gdepth, valid, params, shade_params, cfg, transmission=transmission,
                                      sun=sun, capture=capture)
    stats = _sum_stats([o[2] for o in outs], coll)
    return image, Framebuffer(depth=gdepth, vis=gvis), [o[1] for o in outs], stats


def winning_draws(capture: dict, gvis, n_shards: int, cfg):
    """The draw (index into the unsharded draw list) that wins each pixel
    [H, W] int64, from a sharded frame's capture: at each local shard's
    owned pixels its record's cluster and the cluster's draw
    (frame.debug_inputs), shard-local draw d of shard s being draw
    d * n_shards + s; -1 elsewhere (uncovered, or under Distributed owned
    by another rank)."""
    stride = frag_stride(cfg)
    out = torch.full(gvis.shape, -1, dtype=torch.int64, device=gvis.device)
    for cap, s, mine in zip(capture["shards"], capture["shard_ids"], capture["mine"]):
        tc, setup = frame_mod.debug_inputs(cap)
        local = torch.where(mine, gvis - s * stride, 0).to(torch.int64)
        draw = tc["draw_id"][setup["tri_k"][local].to(torch.int64)].to(torch.int64) * n_shards + s
        out = torch.where(mine, draw, out)
    return out


def allreduce_bytes_per_frame(cfg, transmission: bool = False) -> int:
    """Bytes each shard reduces per frame (mesh.py:225): depth max (4 B),
    id min (4 B) and the two packed G-buffer planes' sum (4 B each) per
    pixel, 16 B, twice that with a transmission layer."""
    return cfg.width * cfg.height * 16 * (2 if transmission else 1)


def make_mesh(n_devices: int) -> list:
    """The first n_devices CUDA devices, one per rank of an NCCL group
    (mesh.py:243); raises when fewer exist."""
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(
            f"make_mesh({n_devices}) needs {n_devices} CUDA devices but {have} exist; hold the shards in one "
            "process with InProcess(), or run a gloo group whose ranks share a device")
    return [torch.device("cuda", i) for i in range(n_devices)]
