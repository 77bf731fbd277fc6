"""A camera that stays where the mix puts it (default: the origin, looking
down -z)."""

import numpy as np


def camera(i: int, seed: int, mix: dict):
    return (np.asarray(mix.get("camera_position", [0.0, 0.0, 0.0]), np.float32),
            np.asarray(mix.get("camera_orientation", [0.0, 0.0, 0.0, 1.0]), np.float32))
