"""The setup work's share of its roofline: the least time its bytes and
operations need on the card (core/work.py, counted from a captured steady
frame's inputs) over the device time a frame of the kernel that did it
(`setup_kernel`, from the trace), in %."""

from core.stages import roofline


def read(run):
    return roofline(run, "setup", "setup_kernel")
