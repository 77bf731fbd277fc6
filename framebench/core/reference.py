"""The reference's side of a cell: its scene from the harness's inputs and
frame i of the traffic mix, with the mix's camera path and motion.

A configuration's kind may bring its own (kinds/<kind>.py
`reference_scene`, `reference_render`, with the arguments and returns of
`scene` and `render` here); every caller finds it through `scene` and
`render`, and where the kind has none, `base_scene` and `base_render`
serve."""

from __future__ import annotations

import numpy as np
import torch

from . import hooks

SAMPLES = 16384  # pixels shaded and shadow-tested, unless the configuration says
SUN_TEXELS = 8192  # texels of the sun map aimed through the moving draws at rest
SUN_MOVED = 1.0  # world units a draw has to have moved for its texels to count: three tube radii


def moving_from(num_draws: int, mix: dict) -> int:
    """The first draw of the moving tail (num_draws where nothing moves)."""
    if "tail_share" not in mix:
        return num_draws
    return num_draws - max(int(round(num_draws * mix["tail_share"])), 1)


def samples(config: dict, seed: int, dev) -> torch.Tensor:
    n = config["width"] * config["height"]
    count = min(config.get("samples", SAMPLES), n)
    pick = np.random.default_rng([seed % (1 << 63), 2]).choice(n, size=count, replace=False)
    return torch.as_tensor(np.sort(pick), device=dev)


def scene(config: dict, mix: dict, kind, x, i: int, dev, motion):
    """The reference's scene at frame i (ref.frame.Scene), and the first
    moving draw: the kind's own, or `base_scene`'s."""
    own = hooks.kind_hook(kind, "reference_scene")
    if own is not None:
        return own(config, mix, kind, x, i, dev, motion)
    return base_scene(config, mix, kind, x, i, dev, motion)


def base_scene(config: dict, mix: dict, kind, x, i: int, dev, motion):
    """The reference's scene at frame i from the kind's levels of detail
    and the harness's inputs, and the first moving draw."""
    from ref import frame as ref_frame

    sc = ref_frame.Scene.build(kind.reference_levels(config), x.draws, x.materials, x.mips, dev)
    first = moving_from(len(sc.position), mix)
    if motion is not None:
        sc.position[first:] = motion.positions(sc.position[first:].clone(), i, mix)
    return sc, first


def render(config: dict, mix: dict, kind, x, i: int, seed: int, dev, camera, motion, dtype=torch.float32,
           at=None):
    """Frame i as the reference renders it (ref.frame.Frame, or an object
    with its fields and an `extra` dict), shaded at the samples drawn from
    the seed, or at the pixels `at` (the control, at the reference's): the
    kind's own, or `base_render`'s."""
    own = hooks.kind_hook(kind, "reference_render")
    if own is not None:
        return own(config, mix, kind, x, i, seed, dev, camera, motion, dtype=dtype, at=at)
    return base_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=dtype, at=at)


def base_render(config: dict, mix: dict, kind, x, i: int, seed: int, dev, camera, motion, dtype=torch.float32,
                at=None):
    """Frame i by ref.frame from `scene`'s scene: every draw through one
    z-buffer, post passes alpha-tested, no emissive light."""
    from ref import frame as ref_frame

    sc, _ = scene(config, mix, kind, x, i, dev, motion)
    pos, orient = camera.camera(i, seed, mix)
    cam = config["camera"]
    c = ref_frame.Camera(position=torch.as_tensor(pos, dtype=torch.float32, device=dev),
                         orientation=torch.as_tensor(orient, dtype=torch.float32, device=dev),
                         fov_y=float(np.radians(cam["fov_y_degrees"])), znear=float(cam["znear"]))
    sun = np.asarray(config["sun_direction"], np.float64)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    return ref_frame.render(sc, c, config["width"], config["height"], config["draw_distance"], sun,
                            samples(config, seed, dev) if at is None else at, shadows=mix["shadows"] != "none",
                            dtype=dtype)


def sun_band(config: dict, mix: dict, kind, x, i: int, seed: int, dev, motion, sun_frame):
    """Where the moving draws were at rest and are no longer, in the sun
    map of frame i: texels aimed through the moving draws at rest (drawn
    from the seed), in the program's map frame and size `sun_frame` =
    (dict rows, lo, hi; size), whose draw has moved SUN_MOVED or more and
    whose nearest surface now lies more than SUN_DEPTH_TOL behind where the
    draw at rest was.  (texels, the draws' reverse depths at rest, whether
    the texel counts)."""
    from core.check import SUN_DEPTH_TOL
    from ref import sunmap
    from ref.shade import quat_matrix

    sc, first = scene(config, mix, kind, x, i, dev, motion)
    sf, size = sun_frame
    rows, lo, hi = sunmap.frame_arrays(sf, dev)
    lv = sc.levels[sc.ray_level]
    verts = torch.as_tensor(lv.positions, device=dev)
    faces = torch.as_tensor(lv.faces, device=dev)
    rest = torch.as_tensor(x.draws["position"][first:], dtype=torch.float32, device=dev)
    at = sunmap.aimed_texels(rest, quat_matrix(sc.orientation[first:]), sc.scale[first:], verts,
                             torch.as_tensor(lv.normals, device=dev), rows, lo, hi, size, size,
                             SUN_TEXELS, seed)
    z_now, _ = sunmap.depths(at, rows, lo, hi, size, size, sc.position, sc.orientation, sc.scale, sc.radius, verts,
                             faces)
    at_rest = sc.position.clone()
    at_rest[first:] = rest
    tail = torch.arange(len(at_rest), device=dev) >= first
    z_rest, hit = sunmap.depths(at, rows, lo, hi, size, size, at_rest, sc.orientation, sc.scale, sc.radius, verts,
                                faces, draw_mask=tail)
    ext = float((hi[2] - lo[2]).item()) / 0.998
    moved = (sc.position - at_rest).norm(dim=1) >= SUN_MOVED
    left = (hit >= 0) & ((z_rest - z_now) * ext > SUN_DEPTH_TOL) & moved[hit.clamp_min(0)]
    return at, z_rest, left
