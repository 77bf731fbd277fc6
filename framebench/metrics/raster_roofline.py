"""The raster work's share of its roofline: the least time its bytes and
operations need on the card (core/work.py; the frame's passes and the sun
band) over the device time a frame of `raster_tile` (the trace), in %."""

from core.stages import roofline


def read(run):
    return roofline(run, "raster", "raster_tile")
