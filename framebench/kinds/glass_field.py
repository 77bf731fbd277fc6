"""The glass field: a configuration kind.  The torus field's draws,
materials and textures (kinds/torus_field.py), then the transmission class
and the normal map that the upstream's glTF materials with
KHR_materials_transmission and normal textures bring (frozen in
data/glass_field.py): the configuration's glass material's draws in post
pass 2, its normal-mapped materials given the map in texture slot 1.  The
program's geometry and the reference's levels of detail are the torus
field's.

The program renders the transmission class into a layer of its own and
blends it in the composite, and bends the normal-mapped materials' normals
through a tangent frame, which ref/frame.py does not render: this kind
brings its own reference (ref/glass.py) and numbers of its own beside the
harness's, which read the opaque buffer as for the torus field:

- `layer_geom`: of the pixels where either side's layer is in front (the
  layer covers them and is nearer than the opaque surface, or the opaque
  buffer is empty there), those where only one side has it in front, or
  where the layer's view distances differ by geom's rule;
- `layer_visible`: glass draws with 16+ front pixels on one side and none
  on the other, over the glass draws with 16+ on either;
- `layer_missed`: glass draws with 16+ front pixels in the reference that
  the carried visibility state marks hidden, over those draws;
- `layer_image`: over the sampled pixels in either side's front, the mean
  of the largest difference of a colour channel;
- `layer_behind`: the same over the sampled pixels that both sides' layers
  cover where neither has it in front (a blend there shows);
- `normal`: over the sampled pixels that both sides see on the same
  normal-mapped draw, facing the eye (N.V > 0.25 on the reference's
  interpolated normal N), how far the program's mean bend departs from
  the reference's, as a share of the reference's: the bend is the angle
  between the shading normal and N.  The normal map's mips are even-texel
  subsamples and the planar uvs change six tiles across the tube's
  thickness, so two levels of detail that depart by a pixel sample
  unrelated texels of the map: pixel by pixel the bent normals of two
  sound renderers differ as much as a renderer that ignores the map, while
  the mean bend over the frame holds.
"""

from __future__ import annotations

import math
import os

import torch

from core import hooks
from core.check import COUNTS, DEPTH_PX, DEPTH_TOL, MIN_PIXELS, share
from data import glass_field as glass_data

_torus = hooks.load(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "kinds",
                    "torus_field")
program_geometry = _torus.program_geometry
reference_levels = _torus.reference_levels

def make_inputs(config: dict, seed: int):
    """The torus field's inputs with the glass classes and the normal map."""
    x = _torus.make_inputs(config, seed)
    gl = config["glass"]
    x.mips = glass_data.glass_classes(x.materials, x.mips, x.draws["material_index"], x.draws["post_pass"],
                                      gl["material"], gl["normal_mapped"], gl["normal_map_size"],
                                      gl["normal_map_seed"])
    return x


def reference_render(config, mix, kind, x, i, seed, dev, camera, motion, dtype=torch.float32, at=None):
    """Frame i by ref/glass.py: the opaque buffer (classes 0 and 1), the
    transmission layer and the blend, shaded at the seed's samples or at
    `at`."""
    from core import reference
    from ref import glass as ref_glass

    if motion is not None:
        raise ValueError("the glass field's reference renders no motion")
    sc, _ = reference.base_scene(config, mix, kind, x, i, dev, None)
    pos, orient = camera.camera(i, seed, mix)
    cam = config["camera"]
    c = ref_glass.Camera(position=torch.as_tensor(pos, dtype=torch.float32, device=dev),
                         orientation=torch.as_tensor(orient, dtype=torch.float32, device=dev),
                         fov_y=math.radians(cam["fov_y_degrees"]), znear=float(cam["znear"]))
    sun = torch.as_tensor(config["sun_direction"], dtype=torch.float64)
    sun = (sun / sun.norm()).float().numpy()
    return ref_glass.render(sc, c, config["width"], config["height"], config["draw_distance"], sun,
                            reference.samples(config, seed, dev) if at is None else at,
                            normal_texture=[int(v) for v in x.materials["textures"][:, 1]],
                            shadows=mix["shadows"] != "none", dtype=dtype)


def program_extra(out, capture, config):
    """The program's replayed frame as compare_extra reads it: per pixel the
    opaque buffer's and the layer's view distance and draw, the image and
    the shading normal; per draw the carried visibility."""
    from niagara_tpu_torch.ops import cullmath
    from niagara_tpu_torch.ops.raster import INVALID_FRAG
    from niagara_tpu_torch.render import frame

    znear = float(config["camera"]["znear"])
    tc, setup_all = frame.debug_inputs(capture)

    def view(depth, vis):
        depth, vis = depth.reshape(-1), vis.reshape(-1)
        covered = (vis != INVALID_FRAG) & (depth > 0)
        w = torch.where(covered, znear / torch.where(covered, depth, 1.0), torch.inf)
        k = setup_all["tri_k"][torch.where(covered, vis, 0).to(torch.int64)]
        return w, torch.where(covered, tc["draw_id"][k].to(torch.int64), -1)

    if "g1" not in capture or "attrs" not in capture:
        raise SystemExit("framebench: the program's capture holds no shading normal (\"g1\", \"attrs\"): it "
                         "cannot be compared with the glass field's reference")
    fb, layer = out["fb"], capture["layer"]
    w, draw = view(fb.depth, fb.vis)
    w_layer, layer_draw = view(layer["depth"], layer["vis"])
    normal = cullmath.oct_decode(capture["g1"][..., :2] * 2.0 - 1.0).reshape(-1, 3)
    return dict(w=w, draw=draw, w_layer=w_layer, layer_draw=layer_draw,
                color=out["image"].reshape(-1, 3).float(), normal=normal,
                base_normal=capture["attrs"][..., 0:3].reshape(-1, 3).float(),
                layer_vis=out["state"].draw_vis.reshape(-1) != 0)


def compare_extra(p, ref, pixel):
    """The kind's numbers: `p` program_extra's, or the control's frame's
    `extra` with `at` (its colour and normal already at the samples), `ref`
    the reference's frame (its `extra` holds the same fields)."""
    r = ref.extra
    samples = ref.samples
    at = (lambda a: a) if "at" in p else (lambda a: a[samples])  # the per-sample fields
    front_p, front_r = front(p["w"], p["w_layer"]), front(r["w"], r["w_layer"])
    either = front_p | front_r
    rel = torch.abs(p["w_layer"] - r["w_layer"]) / torch.where(front_r, r["w_layer"], 1.0)
    off = (front_p != front_r) | (front_p & front_r & (rel > max(DEPTH_TOL, DEPTH_PX * pixel)))
    out = {"layer_geom": share(off, either, "layer_geom")}

    D = len(r["layer_vis"])
    pp = torch.bincount(p["layer_draw"][front_p], minlength=D)
    rp = torch.bincount(r["layer_draw"][front_r], minlength=D)
    big = (pp >= MIN_PIXELS) | (rp >= MIN_PIXELS)
    out["layer_visible"] = share(((pp >= MIN_PIXELS) & (rp == 0)) | ((rp >= MIN_PIXELS) & (pp == 0)), big,
                                 "layer_visible")
    out["layer_missed"] = share(~p["layer_vis"], rp >= MIN_PIXELS, "layer_missed")

    diff = (at(p["color"]) - r["color"]).abs().amax(dim=1)
    seen = either[samples]
    out["layer_image"] = float(diff[seen].mean()) if bool(seen.any()) else 0.0
    behind = (torch.isfinite(p["w_layer"]) & torch.isfinite(r["w_layer"]) & ~either)[samples]
    COUNTS["layer_behind"] = int(behind.sum())
    out["layer_behind"] = float(diff[behind].mean()) if bool(behind.any()) else 0.0

    same = (p["draw"][samples] == r["draw"][samples]) & (r["draw"][samples] >= 0) & r["mapped"] & r["facing"]
    COUNTS["normal"] = int(same.sum())
    if bool(same.any()):
        ours = bend(at(p["normal"])[same], at(p["base_normal"])[same]).mean()
        theirs = bend(r["normal"][same], r["base_normal"][same]).mean()
        out["normal"] = float(torch.abs(ours - theirs) / torch.clamp_min(theirs, 1e-6))
    else:
        out["normal"] = 0.0
    return out


def bend(normal, base):
    """Degrees between normals [K, 3] and the interpolated normals [K, 3]."""
    cos = (normal * base).sum(1) / torch.clamp_min(normal.norm(dim=1) * base.norm(dim=1), 1e-20)
    return torch.rad2deg(torch.acos(torch.clamp(cos, -1.0, 1.0)))


def front(w, w_layer):
    """Where the layer is in front: it covers the pixel nearer than the
    opaque surface, or over an empty opaque buffer."""
    return torch.isfinite(w_layer) & (w_layer < w)
