"""Device idle ms a frame under the attribute resolve, G-buffer and
composite spans (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("shade", "G-buffer", "composite"))
