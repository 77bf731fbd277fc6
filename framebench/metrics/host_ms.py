"""Host ms a frame: the StageTimer host column's sum (the host's enqueue
time of the frame, render_frame's loop and the harness's calls into it)."""

from core.stages import host_ms


def read(run):
    return host_ms(run)
