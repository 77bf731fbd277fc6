"""Device idle ms a frame under the setup and raster spans of both passes
(core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("early setup", "early emit+sort+raster", "late setup+raster"))
