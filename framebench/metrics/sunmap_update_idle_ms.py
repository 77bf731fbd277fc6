"""Device idle ms a frame under the sun-map update's spans: the band's
cull, setup and raster (ops/sunmap.py render_sun_map) and its splice
(pack_band) (core/spans.py).  The harness's tail and scene moves are the
frame loop's."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("sun cull", "sun setup", "sun raster", "pack_band"))
