"""Device ms a frame of the sun map's shadow resolve and blur
(ops/sunmap.py shadow_map_pass)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("sun-map resolve+blur",))
