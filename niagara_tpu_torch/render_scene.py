"""The viewer: renders frames of a scene to PNG images with a HUD of frame
stats (tools/render_scene.py, the reference's viewer).

    python -m niagara_tpu_torch.render_scene [scene.obj ... | scene.gltf | scene.glb]
        [--draws N] [--frames N] [--size WxH] [--out DIR] [--orbit]
        [--camera FILE] [--debug meshlet|draw|depth] [--config 0-5]
        [--downsample N] [--watch]
        [--device cuda|cpu]

It renders on the card (`--device cuda`, the default) and stops with an
error when there is none; `--device cpu` renders through the kernels'
plain torch versions.  With no scene it renders `--draws` draws of the
procedural torus (cooker.cook_procedural), which stands in for the
reference's default kitten.obj.  .obj scenes are cooked through the
scene cache in .cache/ (cooker.cook_or_load).  A glTF scene brings its
own draws, materials, textures, camera and sun; its draw classes are the loader's,
and as in the reference the frame renders the alpha class when the scene
has opacity masks (post_passes 2) and the opaque class otherwise, so
transmission draws are not drawn (FrameConfig(post_passes=3) draws them).
`--config N` applies the staged configuration N (render/presets.py) minus
its shadows.  `--shadows` ray-traces the sun's shadows against a BVH of
the scene (ops/shadow.py: one BLAS per mesh, a TLAS over the draws) built
on the host before the first frame, with the alpha-tested any-hit
(shadow_quality 1) when the scene has opacity masks.  `--watch`
re-renders in a fresh process whenever a source file of the port (.py,
.cu, .cpp, .h) or the scene changes; with `--shadows` it renders once.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from . import cooker, scene as scene_mod
from .cooker import opacity
from .ops import shade, shadow
from .render import camera as camera_mod, frame, hud, presets, textures
from .utils import math3d
from .utils.png import write_png
from .utils.profiling import FrameProfiler

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
DEFAULT_OUT = os.path.join(ROOT, ".cache", "frames")
# the scene cache of .obj scenes (tools/render_scene.py:93)
SCENE_CACHE = os.path.join(ROOT, ".cache")

# the reference viewer's budgets (tools/render_scene.py:122-131)
VIEWER_CAPACITIES = dict(cmd_capacity=1 << 16, cluster_capacity=1 << 16, pair_capacity=1 << 20,
                         late_cluster_capacity=1 << 14, late_tri_capacity=1 << 18)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m niagara_tpu_torch.render_scene",
                                 description="Render frames of a scene to PNG images with a HUD.")
    ap.add_argument("scene", nargs="*",
                    help=".obj files, or one .gltf/.glb; none renders the procedural torus (cooker.cook_procedural), "
                    "which stands in for the reference's kitten.obj (not in the repository)")
    ap.add_argument("--draws", type=int, default=10000, help="draws of an .obj scene or the torus")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="1920x1080", help="WxH, multiples of 128x8")
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory of the frame_NNN.png files")
    ap.add_argument("--orbit", action="store_true", help="orbit the camera around the scene")
    ap.add_argument("--camera", default=None, help="camera file (JSON, the reference's format): loaded when it "
                    "exists, written after the last frame")
    ap.add_argument("--shadows", action="store_true",
                    help="ray-traced sun shadows (a BVH of the scene; alpha-tested with opacity masks); with --watch "
                    "it renders once")
    ap.add_argument("--debug", default=None, choices=["meshlet", "draw", "depth"], help="debug visualization")
    ap.add_argument("--config", type=int, default=None, choices=range(6),
                    help="staged configuration (render/presets.py): 0 no culling, every draw at LOD 0, one pass; "
                    "1 frustum/cone/LOD culling, one pass; 2 two-pass occlusion culling; 3 textured content; "
                    "4/5 animation and sun shadows (their shadows are dropped here)")
    ap.add_argument("--downsample", type=int, default=1, help="write every Nth pixel of each row and column")
    ap.add_argument("--watch", action="store_true",
                    help="re-render in a fresh process whenever a source of the port or the scene changes")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return ap.parse_args(argv)


def load(args) -> types.SimpleNamespace:
    """The command line's scene: `scene` (numpy device layout), `table`
    (texture table or None), `camera`, `sun` (direction or None), `masks`
    (opacity masks or None), and what the ray-traced shadows build from:
    `geometry`, `draws`, `materials` and `mips` (texture mips; None for
    an .obj scene or the torus)."""
    table = masks = sun = mips = None
    cam = camera_mod.Camera()
    if args.scene and args.scene[0].endswith((".gltf", ".glb")):
        from .cooker import gltf

        sd = gltf.load_scene(args.scene[0])
        geometry, draws, materials = sd.geometry, sd.draws, sd.materials
        if sd.texture_paths:
            mips, substituted = textures.load_texture_mips(
                sd.texture_paths, base_dir=os.path.dirname(os.path.abspath(args.scene[0])))
            table = textures.build_texture_table(mips)
            print(f"texture table: {len(sd.texture_paths)} textures ({len(substituted)} substituted), "
                  f"{table.texels.shape[0] * 4 / 1e6:.1f} MB texels")
            masks = opacity.bake_opacity(geometry, draws, materials, mips)
            if masks is not None:
                print(f"opacity bake: {int((masks[..., 6] > 0).sum())} alpha-tested triangles masked")
        if sd.camera_position is not None:
            cam = camera_mod.Camera(position=sd.camera_position, orientation=sd.camera_orientation,
                                    fov_y=sd.camera_fov_y)
        sun = sd.sun_direction
    else:
        geometry = cooker.cook_or_load(args.scene, cache_dir=SCENE_CACHE) if args.scene else cooker.cook_procedural()
        draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=args.draws)
        materials = None
    np_scene = scene_mod.upload(geometry, draws, materials, masks, texture_table=table)
    return types.SimpleNamespace(scene=np_scene, table=table, camera=cam, sun=sun, masks=masks, geometry=geometry,
                                 draws=draws, materials=materials, mips=mips)


def run(argv=None, capture: dict | None = None) -> dict:
    """Render the frames the command line asks for; `capture` receives the
    last frame's kernel inputs (frame.render_frame).  Returns the PNG
    paths, the last frame's stats, framebuffer and image (as written,
    before the HUD), the device scene, frame inputs and config, the camera,
    each frame's own time (ms) and the profiler's EWMA of them (the HUD's)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("render_scene: torch.cuda.is_available() is false -- no GPU to render on; "
                         "pass --device cpu to render on the CPU")
    width, height = map(int, args.size.split("x"))
    os.makedirs(args.out, exist_ok=True)

    src = load(args)
    table, cam, sun, masks = src.table, src.camera, src.sun, src.masks
    ds = scene_mod.from_numpy(src.scene, device)
    tex = None if table is None else textures.to_device(table, device)
    bvh = None
    if args.shadows:
        bvh = shadow.build_scene_rt(src.geometry, src.draws, src.materials, src.mips)[0].to(device)
        print(f"shadow BVH: {bvh.nodes.shape[0]} nodes, {bvh.tri_v0.shape[0]} tris")
    if args.camera and os.path.exists(args.camera):
        cam = camera_mod.load_camera(args.camera)
        print(f"loaded camera from {args.camera}")

    cfg = frame.FrameConfig(width=width, height=height, post_passes=2 if masks is not None else 1,
                            shadows=args.shadows, shadow_quality=1 if args.shadows and masks is not None else 0,
                            **VIEWER_CAPACITIES)
    settings = camera_mod.RenderSettings()
    if args.config is not None:
        ov = presets.frame_overrides(args.config)
        ov.pop("shadows", None)  # the sun's shadows need a BVH: --shadows
        cfg = dataclasses.replace(cfg, **ov)
        settings = presets.settings_for(args.config, settings)
        print(f"config preset {args.config}: {settings}")
    state = frame.init_state(ds.num_draws, ds.meshlet_visibility_count, device)
    prof = FrameProfiler(device=str(device))

    paths, times = [], []
    image = fb = stats = params = None
    for n in range(args.frames):
        if args.orbit:
            cam.orientation = math3d.quat_axis_angle(np.array([0, 1, 0]), 2 * np.pi * n / max(args.frames, 1))
        params, sp = frame.make_frame_inputs(cam, settings, cfg, sun_direction=sun)
        prof.begin_frame()
        last = n == args.frames - 1
        image, fb, state, stats = frame.render_frame(ds, state, params, sp, cfg, textures=tex, bvh=bvh,
                                                     capture=capture if last else None)
        if args.debug:
            # the reference's debug view: the next frame's core from the new state
            dbg = {}
            fb_dbg = frame.frame_core(ds, state, params, cfg, capture=dbg)[0]
            image = shade.debug_visualize(fb_dbg, *frame.debug_inputs(dbg), args.debug)
        ms = prof.end_frame()
        times.append(prof.last_ms)
        if args.downsample > 1:
            image = image[::args.downsample, ::args.downsample]
        lines = [f"frame {ms:8.2f} ms", f"draws visible {int(stats.visible_draws)}",
                 f"clusters e/l {int(stats.early_clusters)}/{int(stats.late_clusters)}"]
        path = os.path.join(args.out, f"frame_{n:03d}.png")
        write_png(path, hud.draw_hud(image, lines).cpu().numpy())
        paths.append(path)
        print(f"{path}: {ms:.1f} ms, visible draws {int(stats.visible_draws)}")

    if args.camera:
        camera_mod.save_camera(args.camera, cam)
        print(f"saved camera to {args.camera}")
    if args.frames > 0:
        print(prof.report(stats))
    return dict(paths=paths, stats=stats, fb=fb, image=image, scene=ds, params=params, cfg=cfg, camera=cam,
                frame_ms=times, frame_ewma_ms=prof.frame.value)


def watch_loop(argv: list[str], scene_files: list[str]) -> int:
    """Re-render in a fresh process (fresh imports, kernels rebuilt from
    changed sources) whenever a .py, .cu, .cpp or .h file of the port or a
    scene file changes (tools/render_scene.py:189); a failed render keeps
    the last good frames.  Runs until interrupted."""

    def snapshot():
        stamp = {}
        for root, _, files in os.walk(PACKAGE_DIR):
            for f in files:
                if f.endswith((".py", ".cu", ".cpp", ".h")):
                    p = os.path.join(root, f)
                    stamp[p] = os.path.getmtime(p)
        for p in scene_files:
            stamp[p] = os.path.getmtime(p)
        return stamp

    child = [sys.executable, "-m", "niagara_tpu_torch.render_scene", *(a for a in argv if a != "--watch")]
    if "--frames" not in argv:
        child += ["--frames", "1"]
    last = snapshot()
    print(f"watch mode: {len(last)} files; Ctrl-C to stop")
    render = True
    while True:
        if render:
            t0 = time.time()
            rc = subprocess.run(child, cwd=ROOT).returncode
            print(f"[watch] OK in {time.time() - t0:.1f}s" if rc == 0 else
                  f"[watch] FAILED (rc={rc}); keeping last good frames")
            render = False
        time.sleep(1.0)
        now = snapshot()
        changed = [p for p in now if now.get(p) != last.get(p)] + [p for p in last if p not in now]
        if changed:
            print(f"[watch] changed: {', '.join(os.path.basename(p) for p in changed[:4])}")
            last, render = now, True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.watch and not args.shadows:
        return watch_loop(argv, [p for p in args.scene if os.path.exists(p)])
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
