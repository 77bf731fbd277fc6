"""The torus field's inputs, frozen here so that a change to the program does
not move them: the draw scatter, the procedural torus, the checker materials
with their alpha class, and the animated tail's motion.

Each function is a copy of the program's generator as it stood when the
benchmark was written (niagara_tpu_torch/cooker/synth.py `synthesize_draws`,
`synthesize_planar_uvs`, `synthesize_materials`, the class split of
`alpha_scene`; cooker/cook.py `procedural_mesh`, `procedural_obj`'s text;
bench.py `sun_delta`), with the scatter's PCG state taken from the seed.
Everything is numpy; the harness hands the same arrays to the program and
to the reference.
"""

from __future__ import annotations

import numpy as np

from .pcg import PCG_DEFAULT_INC, pcg32_sequence, rand01_from_bits

F = np.float32


def scatter_draws(mesh_count: int, draw_count: int, state: int, scatter_range: float = 300.0) -> dict:
    """Random draw placement in a cube of half-width `scatter_range`, 9 PCG32
    outputs per draw from `state` (the upstream's is 0x42): position,
    scale in [2, 4), a random axis and an angle in [0, 90) degrees."""
    n = draw_count
    bits = pcg32_sequence(9 * n, state=int(state) % (1 << 64), inc=int(PCG_DEFAULT_INC)).reshape(n, 9)
    mesh_index = (bits[:, 0] % np.uint32(mesh_count)).astype(np.int32)
    r01 = rand01_from_bits(bits[:, 1:])
    sr = F(scatter_range)
    position = (r01[:, 0:3].astype(F) * (sr * F(2))) - sr
    scale = (r01[:, 3].astype(F) + F(1)) * F(2)
    axis_raw = r01[:, 4:7].astype(F) * F(2) - F(1)
    axis_len = np.sqrt(np.sum(axis_raw * axis_raw, axis=1, dtype=F)).astype(F)
    axis = axis_raw / axis_len[:, None]
    half = np.radians(r01[:, 7].astype(F) * F(90)).astype(F) * F(0.5)
    orientation = np.concatenate(
        [axis * np.sin(half, dtype=F)[:, None], np.cos(half, dtype=F)[:, None]], axis=1
    ).astype(F)
    return dict(
        position=position.astype(F),
        scale=scale.astype(F),
        orientation=orientation,
        mesh_index=mesh_index,
        meshlet_visibility_offset=np.zeros(n, dtype=np.uint32),
        post_pass=np.zeros(n, dtype=np.int32),
        material_index=np.zeros(n, dtype=np.int32),
    )


def torus_mesh(ring_segments: int = 512, tube_segments: int = 56, tube_radius: float = 0.12,
               tube_bump: float = 0.3, diameter: float = 1.8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded noise-displaced thin torus: (positions [V,3], normals [V,3],
    faces [F,3]) -- closed, genus 1, centered, `diameter` across, CCW front
    faces, smooth area-weighted vertex normals."""
    u = np.arange(ring_segments) * (2.0 * np.pi / ring_segments)
    v = np.arange(tube_segments) * (2.0 * np.pi / tube_segments)
    U, V = np.meshgrid(u, v, indexing="ij")
    rng = np.random.default_rng(7)
    fu, fv = rng.integers(1, 7, size=8), rng.integers(1, 5, size=8)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=8)
    bump = sum(np.sin(fu[i] * U + fv[i] * V + phase[i]) / (i + 1) for i in range(8))
    r = tube_radius * (1.0 + tube_bump * bump / np.abs(bump).max())
    ring = 1.0 + r * np.cos(V)
    pos = np.stack([ring * np.cos(U), ring * np.sin(U), r * np.sin(V)], axis=-1).reshape(-1, 3)
    idx = np.arange(U.size).reshape(U.shape)
    nu = np.roll(idx, -1, axis=0)
    nv, nuv = np.roll(idx, -1, axis=1), np.roll(nu, -1, axis=1)
    faces = np.concatenate([np.stack([idx, nu, nuv], -1).reshape(-1, 3),
                            np.stack([idx, nuv, nv], -1).reshape(-1, 3)])
    pos -= pos.mean(axis=0)
    pos *= (diameter / 2.0) / np.linalg.norm(pos, axis=1).max()
    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]], pos[faces[:, 2]] - pos[faces[:, 0]])
    nrm = np.zeros_like(pos)
    for c in range(3):
        np.add.at(nrm, faces[:, c], fn)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm, faces


def obj_text(pos, nrm, faces) -> str:
    """The mesh as OBJ text (v / vn / f v//n), 6 decimals."""
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in nrm]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces + 1]
    return "\n".join(lines) + "\n"


def planar_uvs(vpos: np.ndarray, tiles: float = 6.0) -> np.ndarray:
    """An XZ-planar uv chart normalized to [0, tiles] over the mesh bounds,
    f16 [V, 2]."""
    pos = vpos.astype(np.float32)
    lo = pos.min(axis=0)
    ext = np.maximum(pos.max(axis=0) - lo, 1e-6)
    uv = (pos[:, [0, 2]] - lo[[0, 2]]) / ext[[0, 2]] * tiles
    return uv.astype(np.float16)


def checker_materials(draw_count: int, num_materials: int = 8, tex_size: int = 256, seed: int = 7):
    """Checker-textured materials, the last an alpha cutout.  Returns
    (materials dict, texture mips list, material_index [D] i32, post_pass
    [D] i32: 1/num_materials of the draws in the alpha class)."""
    rng = np.random.default_rng(seed)
    texture_mips = []
    for t in range(num_materials):
        base = np.zeros((tex_size, tex_size, 4), np.uint8)
        yy, xx = np.mgrid[0:tex_size, 0:tex_size]
        checker = ((xx // 16 + yy // 16) % 2).astype(bool)
        c0 = rng.integers(60, 255, 3)
        c1 = rng.integers(60, 255, 3)
        base[..., :3] = np.where(checker[..., None], c0, c1).astype(np.uint8)
        base[..., 3] = 255
        if t == num_materials - 1:
            base[..., 3] = np.where(checker, 255, 0).astype(np.uint8)
        mips = [base]
        while mips[-1].shape[0] > 1:
            mips.append(mips[-1][::2, ::2])
        texture_mips.append(mips)
    materials = dict(
        diffuse=np.ones((num_materials, 4), np.float32),
        specular=np.tile(np.array([[1.0, 1.0, 1.0, 0.3]], np.float32), (num_materials, 1)),
        emissive=np.zeros((num_materials, 3), np.float32),
        textures=np.concatenate(
            [np.arange(num_materials, dtype=np.int32)[:, None], np.full((num_materials, 3), -1, np.int32)], axis=1
        ),
    )
    material_index = (np.arange(draw_count) % num_materials).astype(np.int32)
    post_pass = (material_index == num_materials - 1).astype(np.int32)
    return materials, texture_mips, material_index, post_pass


def tail_offset(t: float) -> np.ndarray:
    """The animated tail's offset at time t: 2 (sin t, 0, 1 - cos t), f32 [3]."""
    t = np.float32(t)
    return np.array([np.sin(t), 0.0, 1.0 - np.cos(t)], np.float32) * np.float32(2.0)
