"""What decides `correct`: the program's frame against the reference's
(framebench/ref), rendered from the same inputs.

The two renderers differ by construction (levels of detail, raster rules,
shadow resolution), so each number is a share, held to a limit set from
readings of sound runs and of the control (PERF.md):

- `geom`: of the pixels either side covers, those where one side covers
  and the other does not, or where
  the view distances differ by more than 1% or by more than 4 pixels'
  size at that distance (the levels of detail may each depart by one);
- `image`: over the sampled pixels either side covers, the mean of the
  largest difference of a colour channel (tone-mapped, in [0, 1]);
- `shadow`: sampled pixels that both see on the same surface, facing the
  sun (N.L > 0.25), where the program's sun term and the reference's
  visibility differ by more than 0.5;
- `sunmap` (a mix that moves draws under a sun map): of the sun map's
  texels that a moving draw covered at rest and no longer covers (it has
  moved 1 world unit or more, and the reference's nearest surface there
  now lies more than 2 units behind it), those where the program's map of
  the frame still holds a surface within 2 units of the draw at rest, or
  nearer;
- `visible`: draws covering at least 16 pixels on one side and none on the
  other, over the draws covering 16 on either;
- `missed`: draws covering at least 16 pixels in the reference that the
  program's carried visibility state marks hidden, over the draws covering
  16 there;
- and a configuration kind's own numbers, where it brings them
  (`compare_extra`).
"""

from __future__ import annotations

import torch

DEPTH_TOL, DEPTH_PX, SUN_TOL, FACING, MIN_PIXELS, SUN_DEPTH_TOL = 0.01, 4.0, 0.5, 0.25, 16, 2.0


def program_view(out: dict, capture: dict, znear: float, frame_mod) -> dict:
    """The program's frame as the comparison reads it: view distance, draw
    id, colour and sun term a pixel, the carried draw visibility."""
    from niagara_tpu_torch.ops.raster import INVALID_FRAG

    fb = out["fb"]
    vis = fb.vis.reshape(-1)
    covered = (vis != INVALID_FRAG) & (fb.depth.reshape(-1) > 0)
    w = torch.where(covered, znear / torch.where(covered, fb.depth.reshape(-1), 1.0), torch.inf)
    tc, setup_all = frame_mod.debug_inputs(capture)
    k = setup_all["tri_k"][torch.where(covered, vis, 0).to(torch.int64)]
    draw = torch.where(covered, tc["draw_id"][k].to(torch.int64), -1)
    shadow = capture.get("shadow")
    packed = out.get("packed")
    return dict(w=w, draw=draw, color=out["image"].reshape(-1, 3).float(),
                sun=None if shadow is None else shadow.reshape(-1).float(),
                sun_map=None if packed is None else packed[:, 0].float(),
                draw_vis=out["state"].draw_vis.reshape(-1) != 0)


def reference_view(f) -> dict:
    """A reference frame (ref.frame.Frame) read the same way, as the
    control puts it in the program's place (shaded at the reference's
    samples): its visible draws stand for the carried state."""
    return dict(w=f.w, draw=f.draw, color=f.color, sun=f.sun, draw_vis=f.draw_pixels > 0, at=f.samples)


def pixel_size(config: dict) -> float:
    """A pixel's size at distance 1 under the configuration's camera."""
    import math

    return 2.0 * math.tan(math.radians(config["camera"]["fov_y_degrees"]) / 2.0) / config["height"]


COUNTS: dict = {}  # the last compare's denominators, for the log


def share(bad, of, name=None) -> float:
    n = int(of.sum())
    if name:
        COUNTS[name] = n
    return float((bad & of).sum()) / n if n else 0.0


def compare(p: dict, ref, pixel: float) -> dict:
    """Each compared number of one frame (`p` a program_view or
    reference_view, `ref` the reference's ref.frame.Frame; `pixel` a
    pixel's size at distance 1)."""
    pc, rc = torch.isfinite(p["w"]), torch.isfinite(ref.w)
    rel = torch.abs(p["w"] - ref.w) / torch.where(rc, ref.w, 1.0)
    off = (pc != rc) | (pc & rc & (rel > max(DEPTH_TOL, DEPTH_PX * pixel)))
    out = {"geom": share(off, pc | rc, "geom")}
    samples = ref.samples
    ours = "at" in p  # a reference_view: shaded at the reference's samples already
    color = p["color"] if ours else p["color"][samples]
    seen = (pc | rc)[samples]
    COUNTS["image"] = int(seen.sum())
    out["image"] = float((color - ref.color).abs().amax(dim=1)[seen].mean()) if bool(seen.any()) else 0.0
    if p["sun"] is not None:
        sun = p["sun"] if ours else p["sun"][samples]
        same = ~off[samples] & rc[samples] & (ref.ndotl > FACING)
        bad = (sun - ref.sun).abs() > SUN_TOL
        out["shadow"] = share(bad, same, "shadow")
    D = len(ref.draw_pixels)
    pp = torch.bincount(p["draw"][p["draw"] >= 0], minlength=D)
    rp = ref.draw_pixels
    big = (pp >= MIN_PIXELS) | (rp >= MIN_PIXELS)
    out["visible"] = share(((pp >= MIN_PIXELS) & (rp == 0)) | ((rp >= MIN_PIXELS) & (pp == 0)), big, "visible")
    out["missed"] = share(~p["draw_vis"], rp >= MIN_PIXELS, "missed")
    return out


BASE_NAMES = ("replay", "geom", "image", "shadow", "sunmap", "visible", "missed", "setup_drops")


def compare_extra(kind, p_extra, ref, pixel: float) -> dict:
    """The kind's own numbers (kinds/<kind>.py `compare_extra`: `p_extra`
    what its `program_extra` read of the program's frame, or the control's
    frame's `extra` with `at`, its samples; `ref` the reference's frame),
    each a share by name; none where the kind has none."""
    from . import hooks

    own = hooks.kind_hook(kind, "compare_extra")
    if own is None:
        return {}
    out = {str(k): float(v) for k, v in own(p_extra, ref, pixel).items()}
    clash = sorted(set(out) & set(BASE_NAMES))
    if clash:
        raise SystemExit(f"framebench: kind {kind.__name__}'s compare_extra names {clash}, the harness's own numbers")
    return out


def compare_sun_band(p_depths, band, sun_frame) -> float:
    """`sunmap`: `p_depths` the program's reverse depths at the band's
    texels, `band` core.reference.sun_band's."""
    _, z_rest, left = band
    sf, _ = sun_frame
    ext = float((sf["hi"][2] - sf["lo"][2]).item()) / 0.998
    stale = (p_depths - z_rest) * ext > -SUN_DEPTH_TOL
    return share(stale, left, "sunmap")


def share_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of pixels of two images [H, W, 3] whose bits differ."""
    return float((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).any(dim=-1).float().mean())
