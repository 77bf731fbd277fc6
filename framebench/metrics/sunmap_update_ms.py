"""Device ms a frame of the animated tail's sun-map update: the tail's move,
the band's cull, setup and raster (ops/sunmap.py update_sun_map), the splice
(pack_band) and the scene's move."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("tail move", "sun cull", "sun setup", "sun raster", "pack_band", "scene move"))
