"""Device ms a frame of the transmission layer: its setup and raster and
its G-buffer (render/frame.py's "layer setup+raster" and "layer
G-buffer" spans)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("layer setup+raster", "layer G-buffer"))
