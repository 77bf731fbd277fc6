"""Device idle ms a frame under the bloom span (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("bloom",))
