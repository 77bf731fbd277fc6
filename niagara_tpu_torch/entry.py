"""Entry points for a compile check and a sharded dry run of the port
(the counterpart of __graft_entry__.py, the JAX package's).

    python -m niagara_tpu_torch.entry [--device cuda|cpu]            # entry(): one frame
    python -m niagara_tpu_torch.entry dryrun [N] [--device cuda|cpu]  # dryrun_multichip(N), N = 8

`entry()` returns (fn, args): fn(scene, state, params, shade_params)
renders one 256x256 frame of the small scene through render_frame and
returns (image, new_state).  `dryrun_multichip(n)` renders one sharded
frame (parallel/mesh.py) of 8 * n draws in n shards at 128x64, a quarter
of them in the alpha class, and prints its line.  Both run on the card
unless given device="cpu" (the kernels' plain versions), and stop with an
error when asked for the card and there is none.  The n shards of the dry
run are held in this process with InProcess collectives, on one device:
NCCL refuses two ranks on one card, and JAX's virtual CPU mesh, which the
reference re-executes itself into, has no counterpart here.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import cooker, scene as scene_mod
from .parallel import mesh
from .render import camera, frame

# the reference's configurations (__graft_entry__.py:45-55, 119-130) less
# the legacy path's max_groups, small_capacity and big_capacity, which the
# port does not have
ENTRY_CONFIG = dict(width=256, height=256, cmd_capacity=1 << 10, cluster_capacity=1 << 12, pair_capacity=1 << 14)
DRYRUN_CONFIG = dict(width=128, height=64, cmd_capacity=256, cluster_capacity=512, pair_capacity=1 << 12,
                     post_passes=2)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("niagara_tpu_torch.entry: torch.cuda.is_available() is false -- no GPU to render on; "
                           "pass device='cpu' to render on the CPU")
    return dev


def _small_scene(draw_count: int = 64):
    """(geometry, draws): the procedural torus through the scene cache in
    cooker.CACHE_DIR, draw_count draws of the reference's PCG scatter
    placed in front of the default camera (__graft_entry__.py:19-31)."""
    geometry = cooker.cook_procedural()
    draws = cooker.synthesize_draws(geometry.meshes.count, draw_count=draw_count)
    draws.position[:] = draws.position * 0.02
    draws.position[:, 2] = -3.0 - 0.05 * np.arange(draw_count)
    return geometry, draws


def entry(device="cuda"):
    """(fn, (scene, state, params, shade_params)) of one frame of the
    small scene at ENTRY_CONFIG: the scene and state on `device`, the
    per-frame constants on the host, as render_frame takes them."""
    dev = _device(device)
    geometry, draws = _small_scene()
    scene = scene_mod.from_numpy(scene_mod.upload(geometry, draws), dev)
    cfg = frame.FrameConfig(**ENTRY_CONFIG)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    state = frame.init_state(scene.num_draws, scene.meshlet_visibility_count, dev)

    def fn(scene, state, params, sp):
        image, _, new_state, _ = frame.render_frame(scene, state, params, sp, cfg)
        return image, new_state

    return fn, (scene, state, params, sp)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded frame of 8 * n_devices draws (every fourth in the alpha
    class) in n_devices shards from a cold state, at DRYRUN_CONFIG;
    checks the image's shape and finiteness and prints
    "dryrun_multichip(n): ok; visible_draws=... clusters=..."
    (__graft_entry__.py:143).  Returns the image, the merged framebuffer,
    the shards' new states and the summed stats."""
    dev = _device(device)
    geometry, draws = _small_scene(draw_count=8 * max(n_devices, 1))
    draws.post_pass[::4] = 1
    cfg = frame.FrameConfig(**DRYRUN_CONFIG)
    scenes = mesh.shard_draws(geometry, draws, n_devices, device=dev)
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    image, fb, states, stats = mesh.render_sharded_frame(scenes, mesh.init_sharded_state(scenes), params, sp, cfg,
                                                         mesh.InProcess())
    if tuple(image.shape) != (cfg.height, cfg.width, 3) or not bool(torch.isfinite(image).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): image of shape {tuple(image.shape)} with "
                           f"{int((~torch.isfinite(image)).sum())} values not finite")
    print(f"dryrun_multichip({n_devices}): ok; visible_draws={int(stats.visible_draws)} "
          f"clusters={int(stats.late_clusters)}")
    return dict(image=image, fb=fb, states=states, stats=stats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m niagara_tpu_torch.entry",
                                 description="One frame of the small scene (entry), or a sharded dry run.")
    ap.add_argument("mode", nargs="?", choices=["dryrun"], help="dryrun: dryrun_multichip(N)")
    ap.add_argument("n", nargs="?", type=int, default=8, help="the dry run's shards (default 8)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n, device=args.device)
    else:
        fn, fargs = entry(device=args.device)
        out = fn(*fargs)
        print("entry ok:", [tuple(out[0].shape), tuple(out[1].draw_vis.shape), tuple(out[1].vis_words.shape)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
