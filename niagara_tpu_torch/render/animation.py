"""Animation playback (niagara_tpu/render/animation.py): keyframe tracks
resampled at a fixed period at load (cooker/gltf.py `_load_animations`)
and applied to the draws each frame by lerp and slerp.

`AnimationTable` holds numpy arrays, as the loader and the scene cache
write them; `evaluate` and `apply_to_draws` run in torch on the scene's
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AnimationTable:
    """SoA animation tracks (animation.py:21)."""

    draw_index: np.ndarray  # i32 [A] (-1 = none)
    light_index: np.ndarray  # i32 [A] (-1 = none)
    start_time: np.ndarray  # f32 [A]
    period: np.ndarray  # f32 [A]
    key_offset: np.ndarray  # i32 [A]
    key_count: np.ndarray  # i32 [A]
    key_translation: np.ndarray  # f32 [K,3]
    key_scale: np.ndarray  # f32 [K]
    key_rotation: np.ndarray  # f32 [K,4] xyzw

    @staticmethod
    def empty():
        return AnimationTable(
            draw_index=np.zeros(0, np.int32),
            light_index=np.zeros(0, np.int32),
            start_time=np.zeros(0, np.float32),
            period=np.ones(0, np.float32),
            key_offset=np.zeros(0, np.int32),
            key_count=np.zeros(0, np.int32),
            key_translation=np.zeros((0, 3), np.float32),
            key_scale=np.zeros(0, np.float32),
            key_rotation=np.zeros((0, 4), np.float32),
        )


def _dot4(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]) + a[..., 3] * b[..., 3]


def _slerp(q0, q1, t):
    """Quaternion slerp with shortest-path handling (animation.py:50)."""
    d = _dot4(q0, q1)[..., None]
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-4
    safe = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    n = torch.sqrt(_dot4(q, q))[..., None]
    return q / torch.clamp_min(n, 1e-20)


def evaluate(anim: AnimationTable, time: float, device="cuda"):
    """Sample all tracks at `time` (animation.py:67).  Returns (draw_index
    [A], position [A,3], scale [A], orientation [A,4], active [A]) as
    tensors on `device`, the card unless the caller asks for the CPU; apply
    with apply_to_draws."""
    f = {k.name: torch.as_tensor(getattr(anim, k.name), device=device) for k in dataclasses.fields(anim)}
    index = (float(time) - f["start_time"]) / f["period"]
    active = index >= 0
    kc = torch.clamp_min(f["key_count"], 1)
    index = torch.remainder(index, kc.to(torch.float32))
    i0 = index.to(torch.int32) % kc
    i1 = (i0 + 1) % kc
    t = (index - torch.floor(index))[:, None]
    k0 = (f["key_offset"] + i0).to(torch.int64)
    k1 = (f["key_offset"] + i1).to(torch.int64)
    kt, ks, kr = f["key_translation"], f["key_scale"], f["key_rotation"]
    position = kt[k0] * (1 - t) + kt[k1] * t
    scale = ks[k0] * (1 - t[:, 0]) + ks[k1] * t[:, 0]
    orientation = _slerp(kr[k0], kr[k1], t)
    return f["draw_index"], position, scale, orientation, active


def apply_to_draws(scene, anim: AnimationTable, time: float):
    """A copy of `scene` (scene.DeviceScene of tensors) with the animated
    draws' transforms at `time` written in; draws without animation, and
    tracks not yet started, are untouched (animation.py:91)."""
    if anim.draw_index.shape[0] == 0:
        return scene
    draw_index, position, scale, orientation, active = evaluate(anim, time, scene.draw_position.device)
    live = active & (draw_index >= 0) & (draw_index < scene.draw_scale.shape[0])  # the rest drop, as there
    target = draw_index[live].to(torch.int64)
    position, scale, orientation = position[live], scale[live], orientation[live]
    xform = torch.cat([position, scale[:, None], orientation], dim=-1)

    def put(base, rows):
        out = base.clone()
        out[target] = rows
        return out

    return dataclasses.replace(
        scene,
        draw_position=put(scene.draw_position, position),
        draw_scale=put(scene.draw_scale, scale),
        draw_orientation=put(scene.draw_orientation, orientation),
        # the baked transform rows (the hot-path copy) stay in sync
        draw_xform_row=put(scene.draw_xform_row, xform),
    )
