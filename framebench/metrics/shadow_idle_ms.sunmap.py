"""Device idle ms a frame under the sun map's resolve and blur span
(core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("sun-map resolve+blur",))
