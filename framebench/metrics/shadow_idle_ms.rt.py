"""Device idle ms a frame under the ray-traced shadows' spans: the rays and
the BVH walk, the checkerboard fill and blur (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, ("rt rays+trace", "rt fill+blur"))
