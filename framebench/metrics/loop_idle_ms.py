"""Device idle ms a frame under no stage of the program: the frame loop's
own time (the frame's inputs, the harness's camera, motion and scene moves,
the wait between frames) (core/spans.py)."""

from core.spans import idle_ms


def read(run):
    return idle_ms(run, (None, "frame inputs"))
