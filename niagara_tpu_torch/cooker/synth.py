"""Synthetic scenes, JAX-free (niagara_tpu/cooker/synth.py).

* `synthesize_draws` (synth.py:19): the reference's PCG32 draw scatter,
  bit-exact;
* `synthesize_planar_uvs` (:60) and `synthesize_materials` (:72): the
  benchmark scene's planar uv chart and its eight checker-textured
  materials, the last an alpha cutout;
* `small_scene_draws`: the port's 48-draw scene in view of the default
  camera, which the parity tests and chip_smoke.py render at 256x128;
* `alpha_scene`: a scene made textured and alpha-classed the way bench.py
  makes it (bench.py:88-99), on a copy of the geometry;
  `small_alpha_scene` is the small scene's form;
* `glass_scene`: the alpha scene with one material's draws moved to the
  transmission class (post pass 2) and the first materials normal-mapped
  by `synthesize_normal_map`; `small_glass_scene` is the small scene's
  form.  The reference has no such scene; its content is the port's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..scene import Draws, Geometry
from ..utils.pcg import PCG_DEFAULT_INC, pcg32_sequence, rand01_from_bits
from .cook import DIAMETER, TUBE_BUMP, TUBE_RADIUS
from .opacity import bake_opacity

F = np.float32
SMALL_UV_TILES = 1.0  # planar uv tiles of small_alpha_scene


def synthesize_draws(mesh_count: int, draw_count: int = 1_000_000) -> Draws:
    """The reference's random draw placement in a 300-unit cube, 9 PCG32
    outputs per draw from state 0x42 (synth.py:19, bit-exact)."""
    n = draw_count
    bits = pcg32_sequence(9 * n, state=0x42, inc=int(PCG_DEFAULT_INC)).reshape(n, 9)
    mesh_index = (bits[:, 0] % np.uint32(mesh_count)).astype(np.int32)
    r01 = rand01_from_bits(bits[:, 1:])
    sr = F(300.0)
    position = (r01[:, 0:3].astype(F) * (sr * F(2))) - sr
    scale = (r01[:, 3].astype(F) + F(1)) * F(2)
    axis_raw = r01[:, 4:7].astype(F) * F(2) - F(1)
    axis_len = np.sqrt(np.sum(axis_raw * axis_raw, axis=1, dtype=F)).astype(F)
    axis = axis_raw / axis_len[:, None]
    half = np.radians(r01[:, 7].astype(F) * F(90)).astype(F) * F(0.5)
    orientation = np.concatenate(
        [axis * np.sin(half, dtype=F)[:, None], np.cos(half, dtype=F)[:, None]], axis=1
    ).astype(F)
    return Draws(
        position=position.astype(F),
        scale=scale.astype(F),
        orientation=orientation,
        mesh_index=mesh_index,
        meshlet_visibility_offset=np.zeros(n, dtype=np.uint32),
        post_pass=np.zeros(n, dtype=np.int32),
        material_index=np.zeros(n, dtype=np.int32),
    )


def small_scene_draws(mesh_count: int) -> Draws:
    """The reference's PCG draws re-placed in view of the default camera
    with seeded numpy (x in [-4,4], y in [-2,2], 3-20 units ahead, scale
    0.6-2.4), the last three replaced by a large ring facing the camera 2.5
    units ahead and two small draws hidden behind the right side of its
    tube, so the late pass has draws to cull: the small scene the parity
    tests and chip_smoke.py render at 256x128."""
    n = 48
    d = synthesize_draws(mesh_count, draw_count=n)
    rng = np.random.default_rng(5)
    d.position[:] = np.stack(
        [rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), -rng.uniform(3, 20, n)], axis=1
    ).astype(F)
    d.scale[:] = rng.uniform(0.6, 2.4, n).astype(F)
    ring = 2.4 * (DIAMETER / 2) / (1 + TUBE_RADIUS * (1 + TUBE_BUMP))  # scaled ring radius
    d.position[-3:] = np.array([[0, 0, -2.5], [ring * 6 / 2.5, 0, -6], [ring * 9 / 2.5, 0, -9]], F)
    d.scale[-3:] = np.array([2.4, 0.15, 0.15], F)
    d.orientation[-3:] = np.array([0, 0, 0, 1], F)  # ring in the xy plane
    return d


def synthesize_planar_uvs(geometry: Geometry, tiles: float = 6.0) -> None:
    """In place: an XZ-planar uv chart normalized to [0, tiles] over the
    mesh bounds (synth.py:60)."""
    pos = geometry.vpos.astype(np.float32)
    lo = pos.min(axis=0)
    ext = np.maximum(pos.max(axis=0) - lo, 1e-6)
    uv = (pos[:, [0, 2]] - lo[[0, 2]]) / ext[[0, 2]] * tiles
    geometry.vuv = uv.astype(np.float16)


def synthesize_materials(draw_count: int, num_materials: int = 8, tex_size: int = 256, seed: int = 7):
    """Checker-textured materials, the last an alpha cutout (synth.py:72).
    Returns (materials dict, texture_mips list, material_index [D] i32,
    post_pass [D] i32: 1/num_materials of the draws in the alpha class)."""
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


def alpha_scene(geometry: Geometry, draws: Draws, cutouts=(), uv_tiles: float = 6.0):
    """The textured, alpha-classed form of a scene, as bench.py builds it:
    planar uvs (`uv_tiles` over the mesh) on a copy of `geometry` (the
    caller's keeps its uvs),
    synthesize_materials over the draws (set in place: 1/8 of them in the
    alpha class, plus the draw ids in `cutouts`), opacity masks baked from
    mip 1.  Returns (geometry copy, draws, materials, masks [M,96,8],
    texture_mips) -- upload takes the first four and the texture table
    built from the mips."""
    g = dataclasses.replace(geometry)
    synthesize_planar_uvs(g, uv_tiles)
    materials, texture_mips, mat_idx, post = synthesize_materials(draws.count)
    cutout = len(texture_mips) - 1
    mat_idx[list(cutouts)] = cutout
    post[list(cutouts)] = 1
    draws.material_index[:] = mat_idx
    draws.post_pass[:] = post
    masks = bake_opacity(g, draws, materials, texture_mips)
    return g, draws, materials, masks, texture_mips


def small_alpha_scene(geometry: Geometry):
    """small_scene_draws through alpha_scene with the near ring (the third
    draw from the end) also in the alpha class and one uv tile over the
    mesh: at 256x128 the draws pick coarse LODs, whose triangles span many
    checker squares at the benchmark's 6 tiles, so their conservative masks
    would be all opaque; at one tile the ring's masks have clear cells and
    the raster-time test discards pixels.  The same tuple as alpha_scene."""
    draws = small_scene_draws(geometry.meshes.count)
    return alpha_scene(geometry, draws, cutouts=(draws.count - 3,), uv_tiles=SMALL_UV_TILES)


GLASS_MATERIAL = 6  # glass_scene's transmission material
NORMAL_MAPPED = 4  # glass_scene normal-maps materials [0, NORMAL_MAPPED)


def synthesize_normal_map(size: int = 256, seed: int = 3) -> list:
    """A seeded tangent-space normal map, RGBA8 with its mips (each the
    previous one's even texels): the normalized gradient of a sum of six
    sines of whole frequencies (so it tiles), n = (-dh/dx, -dh/dy, 1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] * (2.0 * np.pi / size)
    dx = np.zeros((size, size))
    dy = np.zeros((size, size))
    for _ in range(6):
        fx, fy = rng.integers(1, 9, 2)
        amp, phase = rng.uniform(0.02, 0.08), rng.uniform(0, 2 * np.pi)
        c = amp * np.cos(fx * xx + fy * yy + phase)
        dx += c * fx
        dy += c * fy
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8)
    img[..., 3] = 255
    mips = [img]
    while mips[-1].shape[0] > 1:
        mips.append(mips[-1][::2, ::2])
    return mips


def glass_scene(geometry: Geometry, draws: Draws, cutouts=(), uv_tiles: float = 6.0):
    """alpha_scene, then the draws of material GLASS_MATERIAL (1/8 of them)
    in the transmission class and materials [0, NORMAL_MAPPED) normal-mapped
    (texture slot 1) by synthesize_normal_map, appended as the last
    texture.  The masks stay those of the alpha class.  The same tuple as
    alpha_scene."""
    g, draws, materials, masks, mips = alpha_scene(geometry, draws, cutouts=cutouts, uv_tiles=uv_tiles)
    draws.post_pass[draws.material_index == GLASS_MATERIAL] = 2
    materials["textures"][:NORMAL_MAPPED, 1] = len(mips)
    return g, draws, materials, masks, mips + [synthesize_normal_map()]


def small_glass_scene(geometry: Geometry):
    """small_alpha_scene's draws through glass_scene: draws 6, 14, ..., 46
    in the transmission class, the near ring (draw 45) in the alpha class."""
    draws = small_scene_draws(geometry.meshes.count)
    return glass_scene(geometry, draws, cutouts=(draws.count - 3,), uv_tiles=SMALL_UV_TILES)
