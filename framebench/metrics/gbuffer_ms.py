"""Device ms a frame of the attribute resolve, the G-buffer and the
composite (ops/shade.py, the shade kernel)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("shade", "G-buffer", "composite"))
