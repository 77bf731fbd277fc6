"""Device ms a frame of setup, pair emission, sort and raster of both passes
(ops/setup.py, ops/raster_tile.py)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("early setup", "early emit+sort+raster", "late setup+raster"))
