"""The system under test's frame loop for one cell.

`Renderer` builds a configuration's device scene through the program's
upload, opacity bake, texture table and shadow source (the sun map, or the
ray-tracing BVH), and `step` renders frame i of the traffic mix as the
port's viewer does: the camera of frame i (the mix's camera path), the
frame's inputs (frame.make_frame_inputs), the mix's motion of the tail
(with its sun-map band updated and spliced where the mix asks), then
render_frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DROPS = ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped")


def capacities(config: dict) -> dict:
    caps = dict(config["capacities"])
    if "pair_class_caps" in caps:
        caps["pair_class_caps"] = tuple(caps["pair_class_caps"])
    return caps


def sun_direction(config: dict) -> np.ndarray:
    s = np.asarray(config["sun_direction"], np.float64)
    return (s / np.linalg.norm(s)).astype(np.float32)


class Renderer:
    """One configuration under one traffic mix on `dev`.  `camera` and
    `motion` are the mix's hooks (cameras/<name>.py, motions/<name>.py;
    motion None: nothing moves)."""

    def __init__(self, config: dict, mix: dict, x, geometry, dev, seed: int, camera, motion=None):
        from niagara_tpu_torch import scene
        from niagara_tpu_torch.cooker import opacity
        from niagara_tpu_torch.ops import shadow, sunmap
        from niagara_tpu_torch.render import camera as camera_mod, frame, textures
        from niagara_tpu_torch.utils.profiling import stage_marker

        self.frame, self.sunmap, self.camera_mod, self.mark = frame, sunmap, camera_mod, stage_marker
        self.config, self.mix, self.dev, self.seed = config, mix, dev, seed
        self.camera_hook, self.motion = camera, motion
        self.sun = self.bvh = self.tail = None
        c = config
        draws = scene.Draws(**x.draw_arrays())
        masks = opacity.bake_opacity(geometry, draws, x.materials, x.mips)
        table = textures.build_texture_table(x.mips)
        self.ds = scene.from_numpy(scene.upload(geometry, draws, x.materials, masks, texture_table=table), dev)
        self.tex = textures.to_device(table, dev)
        self.cfg = frame.FrameConfig(
            width=c["width"], height=c["height"], post_passes=c["post_passes"], bloom=c["bloom"],
            shadows=mix["shadows"] != "none", shadow_quality=mix.get("shadow_quality", 0),
            shadow_scale=mix.get("shadow_scale", 2), **capacities(c))
        self.settings = camera_mod.RenderSettings(draw_distance=c["draw_distance"])
        self.sun_direction = sun_direction(c)
        D = self.ds.num_draws
        self.moving_from = D - max(int(round(D * mix["tail_share"])), 1) if "tail_share" in mix else D
        self.rest_position = self.ds.draw_position[self.moving_from:].clone()
        self.setup_drops = 0
        if mix["shadows"] == "sun_map":
            self._build_sun_map(x)
        elif mix["shadows"] == "ray_traced":
            if motion is not None:
                raise ValueError("ray-traced shadows with moving draws: the BVH is built once")
            _, rt_static = shadow.build_scene_rt(geometry, draws)
            self.bvh = shadow.refit_tlas(rt_static, scene.Draws(**x.draw_arrays())).to(dev)

    def camera(self, i: int):
        pos, orient = self.camera_hook.camera(i, self.seed, self.mix)
        cam = self.config["camera"]
        return self.camera_mod.Camera(position=pos, orientation=orient, fov_y=float(np.radians(cam["fov_y_degrees"])),
                                      znear=float(cam["znear"]))

    def frame_inputs(self, i: int):
        return self.frame.make_frame_inputs(self.camera(i), self.settings, self.cfg, sun_direction=self.sun_direction)

    def _build_sun_map(self, x):
        """The static map of the draws before the tail, then the tail at
        rest rendered onto it, packed; with `sun_update` the tail's dirty
        band and its per-frame budgets."""
        sm, mix, ds, sunmap = self.config["sun_map"], self.mix, self.ds, self.sunmap
        m, D, n = sm["size"], ds.num_draws, self.moving_from
        _, sp = self.frame_inputs(0)
        from niagara_tpu_torch.scene import Draws

        sf = sunmap.fit_sun_to_draws(sp.sun_direction, Draws(**x.draw_arrays()), device=self.dev)
        texel = sunmap.map_texel_world(sf, m, m)
        static, sdrop = sunmap.build_static_sun_map(ds, sf, map_w=m, map_h=m, texel_world=texel, num_draws=n,
                                                    batch=sm["batch"], **sm["caps"])
        tail = ds.slice_draws(n, D)
        caps = dict(sm["caps"], **mix.get("update_caps", {}))
        at_rest, udrop = sunmap.update_sun_map(tail, sf, static, None, map_w=m, map_h=m, texel_world=texel, **caps)
        self.setup_drops = sdrop + udrop
        self.sun = (sf, sunmap.pack_sun_map(at_rest), (m, m))
        if mix.get("sun_update"):
            window = sunmap.dirty_tile_rows(sf, tail.draw_position, tail.draw_mesh_row[:, 3] * tail.draw_scale, m,
                                            margin=mix["motion_bound"] + 2.0 * texel)
            self.tail = dict(sf=sf, static=static, packed_static=sunmap.pack_sun_map(static), scene=tail,
                             window=window, caps=caps, size=m, texel=texel)

    # ------------------------------------------------------------ a frame

    def moved(self, sc, i: int, first: int):
        """`sc` with draws [first, ...) at the motion's positions of frame i."""
        pos = sc.draw_position.clone()
        pos[first:] = self.motion.positions(self.rest_position, i, self.mix)
        xf = sc.draw_xform_row.clone()
        xf[first:, 0:3] = pos[first:]
        return dataclasses.replace(sc, draw_position=pos, draw_xform_row=xf)

    def tail_update(self, i: int, stages=None, capture=None):
        """The tail moved to frame i, its band rendered onto the static map
        and spliced into the packed table: (packed, drops).  Boundaries:
        "tail move", the port's "sun cull", "sun setup", "sun raster", then
        "pack_band"."""
        sunmap, tl = self.sunmap, self.tail
        mark = self.mark(stages)
        moved = self.moved(tl["scene"], i, 0)
        mark("tail move")
        m, (row0, rows) = tl["size"], tl["window"]
        a, b = row0 * 8, (row0 + rows) * 8
        band, drop = sunmap.update_sun_map(moved, tl["sf"], tl["static"], None, map_w=m, map_h=m,
                                           texel_world=tl["texel"], row_window=tl["window"], stages=stages,
                                           capture=capture, **tl["caps"])
        static = tl["static"]
        packed = sunmap.pack_band(tl["packed_static"], band, a, m, row_above=static[a - 1] if a > 0 else None,
                                  row_below=static[b] if b < m else None)
        mark("pack_band")
        return packed, drop

    def step(self, i: int, state, stages=None, capture=None, sun_capture=None) -> dict:
        """Frame i from `state`: dict(image, fb, state, stats, drops, packed),
        `drops` the frame's steady-state drop counters (commands, clusters,
        triangles, pairs, and the sun band's with a sun-map update), `packed`
        the sun map with the frame's band spliced in (None without an
        update).
        `capture` and `sun_capture` receive the frame's and the sun band's
        kernel inputs (render_frame's and update_sun_map's `capture`)."""
        params, sp = self.frame_inputs(i)
        scene, sun, udrop, packed = self.ds, self.sun, None, None
        if self.tail is not None:
            packed, udrop = self.tail_update(i, stages, sun_capture)
            sun = (sun[0], packed, sun[2])
        if self.motion is not None:
            scene = self.moved(self.ds, i, self.moving_from)
            self.mark(stages)("scene move")
        image, fb, new_state, stats = self.frame.render_frame(
            scene, state, params, sp, self.cfg, textures=self.tex, sun=sun, bvh=self.bvh, capture=capture,
            stages=stages)
        parts = [getattr(stats, k) for k in DROPS] + ([udrop] if udrop is not None else [])
        drops = torch.stack([torch.as_tensor(p, device=self.dev).reshape(()) for p in parts])
        return dict(image=image, fb=fb, state=new_state, stats=stats, drops=drops, packed=packed)

    def sun_frame(self):
        """The sun map's frame (rows, lo, hi) and size, with a sun-map
        update; else None."""
        return None if self.tail is None else (self.tail["sf"], self.tail["size"])

    def init_state(self):
        return self.frame.init_state(self.ds.num_draws, self.ds.meshlet_visibility_count, self.dev)

    def free(self):
        """Drop the device scene and everything derived from it."""
        for k in ("ds", "tex", "sun", "bvh", "tail", "rest_position"):
            setattr(self, k, None)
