"""Device idle ms a frame under the transmission layer's spans, its setup
and raster and its G-buffer (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("layer setup+raster", "layer G-buffer"))
