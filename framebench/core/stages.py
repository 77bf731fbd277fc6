"""Readers' arithmetic over a traced run: stage spans and rooflines."""

from __future__ import annotations

from . import work


def device_ms(run, names) -> float | None:
    """Mean device ms a frame between the named StageTimer boundaries (each
    the time since the boundary before it); None when no frame has one."""
    frames = run.stages or []
    if not any(name in names for f in frames for name, _, _ in f["stages"]):
        return None
    return sum(dev for f in frames for name, dev, _ in f["stages"] if name in names) / len(frames)


def host_ms(run) -> float | None:
    """Mean host ms a frame: the host column's sum over each frame's stages."""
    frames = run.stages or []
    if not frames:
        return None
    return sum(host for f in frames for _, _, host in f["stages"]) / len(frames)


def roofline(run, what: str, kernel: str) -> float | None:
    """100 x the captured frame's `what` work's least time over the trace's
    device ms a frame of kernels named `kernel`; None without either."""
    if run.trace is None or run.work is None:
        return None
    ms = run.trace.kernel_ms_per_frame(kernel)
    nbytes, ops = run.work[what]
    if not ms or not (nbytes or ops):
        return None
    return 100.0 * work.bound_ms(nbytes, ops) / ms
