"""Device ms a frame of the bloom chain and its expansion (ops/bloom.py)."""

from core.stages import device_ms


def read(run):
    return device_ms(run, ("bloom",))
