"""Device ms a frame of the ray-traced shadows: rays, the BVH walk, the
checkerboard fill and blur (ops/shadow.py shadow_pass)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("rt rays+trace", "rt fill+blur"))
