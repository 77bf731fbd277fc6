"""Device ms a frame of the cull: draw and cluster culls of both passes and
the depth pyramid (ops/cull.py, ops/compact.py, ops/pyramid.py)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("early draw cull", "early cluster cull", "pyramid", "late cull"))
