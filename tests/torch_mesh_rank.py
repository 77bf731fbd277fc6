"""One rank of a gloo group rendering the parity scene's sharded frames
on the CPU (tests/test_torch_parallel.py spawns one process per rank).
JAX-free, so that a spawned rank imports only torch and the port."""

import os

import numpy as np
import torch


def render_rank(rank: int, world: int, port: int, mesh_dir: str, out_dir: str, frames: int) -> None:
    """Join the group at tcp://localhost:`port`, take shard `rank` of the
    parity scene (cooker.small_scene_draws of the mesh cooked in
    `mesh_dir`), render `frames` chained sharded frames through the
    Distributed collective and write the last one's image, merged depth
    and vis, this rank's state and the summed stats to
    `out_dir`/rank<rank>.npz."""
    import torch.distributed as dist

    from niagara_tpu_torch import cooker
    from niagara_tpu_torch.parallel import mesh
    from niagara_tpu_torch.render import camera, frame, presets

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        g = cooker.cook_procedural(mesh_dir)
        scenes = [mesh.shard_draws(g, cooker.small_scene_draws(g.meshes.count), world, device="cpu")[rank]]
        states = mesh.init_sharded_state(scenes)
        cfg = frame.FrameConfig(width=256, height=128, **presets.small_capacities())
        params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
        for _ in range(frames):
            image, fb, states, stats = mesh.render_sharded_frame(scenes, states, params, sp, cfg, mesh.Distributed())
        draw_vis, vis_words = frame.state_to_numpy(states[0])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), image=image.numpy(), depth=fb.depth.numpy(),
                 vis=fb.vis.numpy(), draw_vis=draw_vis, vis_words=vis_words,
                 **{f"stats_{k}": v for k, v in stats.to_dict().items()})
    finally:
        dist.destroy_process_group()
