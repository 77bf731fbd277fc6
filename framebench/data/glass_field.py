"""The glass field's additions to the torus field's inputs, frozen here so
that a change to the program does not move them: the tangent-space normal
map and the class move that make the torus field's draws a scene with a
transmission class.

Each function is a copy of the program's generator as it stood when the
benchmark was written (niagara_tpu_torch/cooker/synth.py
`synthesize_normal_map` and the class move of `glass_scene`).  Everything
is numpy; the harness hands the same arrays to the program and to the
reference.
"""

from __future__ import annotations

import numpy as np


def normal_map(size: int = 256, seed: int = 3) -> list:
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


def glass_classes(materials: dict, mips: list, material_index: np.ndarray, post_pass: np.ndarray,
                  glass_material: int = 6, normal_mapped: int = 4, map_size: int = 256, map_seed: int = 3) -> list:
    """In place: the draws of `glass_material` moved to the transmission
    class (post pass 2), and materials [0, normal_mapped) given the normal
    map in texture slot 1, appended as the last texture.  Returns the
    texture mips with the map appended."""
    post_pass[material_index == glass_material] = 2
    materials["textures"][:normal_mapped, 1] = len(mips)
    return mips + [normal_map(map_size, map_seed)]
