"""Device idle ms a frame under the cull's spans: the device waiting while
the host ran the draw and cluster culls of both passes and the depth
pyramid (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("early draw cull", "early cluster cull", "pyramid", "late cull"))
