"""Camera state, camera files and per-frame culling constants, JAX-free
(niagara_tpu/render/camera.py).  The camera file is the reference's JSON
(version 1): files written by either package load in the other."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..utils import math3d

from ..ops.cull import CullParams


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    orientation: np.ndarray = field(default_factory=math3d.quat_identity)
    fov_y: float = float(np.radians(70.0))
    znear: float = 0.1


def save_camera(path: str, camera: Camera) -> None:
    """Write the camera as the reference's version-1 JSON (camera.py:25)."""
    with open(path, "w") as f:
        json.dump({
            "version": 1,
            "position": [float(v) for v in camera.position],
            "orientation": [float(v) for v in camera.orientation],
            "fov_y": float(camera.fov_y),
            "znear": float(camera.znear),
        }, f)


def load_camera(path: str) -> Camera:
    """Read a version-1 camera file (camera.py:42); another version raises
    ValueError."""
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"unsupported camera file version in {path}")
    return Camera(position=np.array(data["position"], dtype=np.float32),
                  orientation=np.array(data["orientation"], dtype=np.float32),
                  fov_y=float(data["fov_y"]), znear=float(data["znear"]))


@dataclass
class RenderSettings:
    """Runtime toggles (the reference's key bindings)."""

    culling: bool = True
    lod: bool = True
    occlusion: bool = True
    cluster_occlusion: bool = True
    cluster_backface: bool = True
    draw_distance: float = 200.0
    debug_lod_step: int = 0


def make_cull_params(camera: Camera, width: int, height: int, pyramid_w: int, pyramid_h: int,
                     settings: RenderSettings, post_pass: int = 0):
    """(CullParams, projection [4,4]) for one frame (camera.py:71); the
    values are the reference's float32 numbers."""
    view = math3d.view_matrix(camera.position, camera.orientation)
    projection = math3d.perspective_projection(camera.fov_y, width / height, camera.znear)
    frustum = math3d.frustum_from_projection(projection)
    lod_target = (2.0 / projection[1, 1]) * (1.0 / height) * (1 << settings.debug_lod_step)
    params = CullParams(
        view=view,
        p00=float(np.float32(projection[0, 0])),
        p11=float(np.float32(projection[1, 1])),
        znear=float(np.float32(camera.znear)),
        zfar=float(np.float32(settings.draw_distance)),
        frustum=frustum,
        lod_target=float(np.float32(lod_target)),
        pyramid_w=float(np.float32(pyramid_w)),
        pyramid_h=float(np.float32(pyramid_h)),
        culling_enabled=int(settings.culling),
        lod_enabled=int(settings.lod),
        occlusion_enabled=int(settings.occlusion),
        cluster_occlusion_enabled=int(settings.occlusion and settings.cluster_occlusion),
        cluster_backface_enabled=int(settings.cluster_backface),
        post_pass=int(post_pass),
    )
    return params, projection
