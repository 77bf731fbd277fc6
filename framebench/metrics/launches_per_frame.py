"""Device operations a frame in the trace: kernels, copies and sets."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    return run.trace.launches_per_frame()
