"""Host-side 3D math (numpy, float32): the functions of
niagara_tpu/utils/math3d.py the port calls, copied.

xyzw quaternions; [4,4] float32 matrices with column vectors (clip = M @ v).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=F)
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True, dtype=F)).astype(F)
    return (v / n).astype(F)


def quat_identity() -> np.ndarray:
    return np.array([0, 0, 0, 1], dtype=F)


def quat_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Quaternion (xyzw) of a rotation by `angle` radians about the unit
    `axis` (math3d.py:32)."""
    axis = np.asarray(axis, dtype=F)
    h = F(angle) * F(0.5)
    q = np.empty(axis.shape[:-1] + (4,), dtype=F)
    q[..., :3] = axis * F(np.sin(h))
    q[..., 3] = np.cos(h)
    return q


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (F(q[i]) for i in range(4))
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=F,
    )


def perspective_projection(fov_y: float, aspect_w_by_h: float, z_near: float) -> np.ndarray:
    """Infinite reverse-Z perspective projection: ndc depth = znear / z."""
    f = F(1.0 / np.tan(fov_y / 2.0))
    P = np.zeros((4, 4), dtype=F)
    P[0, 0] = f / F(aspect_w_by_h)
    P[1, 1] = f
    P[2, 3] = F(z_near)
    P[3, 2] = F(1)
    return P


def view_matrix(position: np.ndarray, orientation: np.ndarray) -> np.ndarray:
    """World -> camera: the inverse of the camera-to-world transform, z
    flipped so that camera-space z is positive in front of the camera."""
    c2w = np.eye(4, dtype=F)
    c2w[:3, :3] = quat_to_mat3(np.asarray(orientation, dtype=F))
    c2w[:3, 3] = np.asarray(position, dtype=F)
    view = np.linalg.inv(c2w).astype(F)
    flip = np.diag(np.array([1, 1, -1, 1], dtype=F))
    return (flip @ view).astype(F)


def normalize_plane(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=F)
    return (p / np.sqrt(np.sum(p[:3] * p[:3], dtype=F)).astype(F)).astype(F)


def frustum_from_projection(P: np.ndarray) -> np.ndarray:
    """[fx.x, fx.z, fy.y, fy.z] of the symmetric left/right and top/bottom
    planes: a camera-space sphere (c, r) is inside when c.z*f[1] - |c.x|*f[0]
    > -r (and the same for y with f[2], f[3])."""
    fx = normalize_plane(P[3] + P[0])
    fy = normalize_plane(P[3] + P[1])
    return np.array([fx[0], fx[2], fy[1], fy[2]], dtype=F)


def previous_pow2(v: int) -> int:
    """Largest power of two strictly less than v (v >= 2), else 1."""
    r = 1
    while r * 2 < v:
        r *= 2
    return r


def image_mip_levels(width: int, height: int) -> int:
    result = 1
    while width > 1 or height > 1:
        result += 1
        width //= 2
        height //= 2
    return result


def quantize_half(v: np.ndarray) -> np.ndarray:
    """float32 -> float16 bit pattern as uint16 (round-to-nearest-even)."""
    return np.asarray(v, dtype=np.float32).astype(np.float16).view(np.uint16)


def quantize_snorm(v: np.ndarray, bits: int) -> np.ndarray:
    """Signed-normalized quantization: clamp to [-1,1], scale by 2^(bits-1)-1,
    round half away from zero.  Returns int32 in [-scale, scale]."""
    scale = F((1 << (bits - 1)) - 1)
    v = np.clip(np.asarray(v, dtype=F), F(-1), F(1))
    round_ = np.where(v >= 0, F(0.5), F(-0.5))
    return (v * scale + round_).astype(np.int32)


def oct_encode(v: np.ndarray) -> np.ndarray:
    """Octahedral encode of unit vectors [...,3] -> [...,2] in [-1,1]."""
    v = np.asarray(v, dtype=F)
    denom = np.abs(v[..., 0]) + np.abs(v[..., 1]) + np.abs(v[..., 2])
    p = v[..., :2] / denom[..., None]
    s = np.where(v[..., :2] >= 0, F(1), F(-1))
    r = np.where((v[..., 2] <= 0)[..., None], (1.0 - np.abs(p[..., ::-1])) * s, p)
    return r.astype(F)


def dequantize_half(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint16).view(np.float16).astype(np.float32)


def oct_decode(e: np.ndarray) -> np.ndarray:
    """Octahedral decode [...,2] -> normalized [...,3]."""
    e = np.asarray(e, dtype=F)
    vz = 1.0 - np.abs(e[..., 0]) - np.abs(e[..., 1])
    t = np.maximum(-vz, 0.0)
    vx = e[..., 0] + np.where(e[..., 0] >= 0, -t, t)
    vy = e[..., 1] + np.where(e[..., 1] >= 0, -t, t)
    v = np.stack([vx, vy, vz], axis=-1).astype(F)
    return normalize(v)


def unpack_normal(np_packed: np.ndarray) -> np.ndarray:
    """10-10-10 snorm normal from its packed u32 (the sign bit ignored)."""
    p = np.asarray(np_packed, dtype=np.uint32)
    out = np.stack(
        [
            ((p >> np.uint32(0)) & np.uint32(1023)).astype(F),
            ((p >> np.uint32(10)) & np.uint32(1023)).astype(F),
            ((p >> np.uint32(20)) & np.uint32(1023)).astype(F),
        ],
        axis=-1,
    )
    return (out / F(511) - F(1)).astype(F)
