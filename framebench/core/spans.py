"""The device's idle time split over the program's spans.

The port wraps each stage of a frame in `torch.profiler.record_function`
ranges named "niagara::<stage>" while the profiler records
(niagara_tpu_torch/utils/profiling.py `span`); the trace keeps them in
`Trace.host_ops` on the kernels' clock.  `idle_us_by_span` cuts every
interval in which the device ran nothing against those ranges: each piece
goes to the innermost span the host was in over it, or to None where the
host was in no span (the harness's camera, motion and scene moves, the
wait between frames).  The pieces of a trace add up to its window less
its busy time, so the idle readers' sum is `idle_pct` of the window.
"""

from __future__ import annotations

import bisect

PREFIX = "niagara::"


def idle_intervals(trace) -> list:
    """(start, end) in us of every interval of the traced window in which
    no device operation ran.  The window ends when the last operation does
    (each traced frame waits for its device) and lasts `window_s`: what the
    host did before the first operation is idle too."""
    out, end = [], None
    for _, _, ts, dur in trace.events:
        if end is not None and ts > end:
            out.append((end, ts))
        end = ts + dur if end is None else max(end, ts + dur)
    if end is None:
        return []
    start = end - trace.window_s * 1e6
    first = trace.events[0][2]
    if start < first:
        out.insert(0, (start, first))
    return out


def _segments(spans: list) -> tuple[list, list]:
    """(boundaries, owner): the span boundaries in order, and the innermost
    span over each segment between two of them (the latest started of those
    that hold it, the shorter on a tie; None where none does)."""
    points = sorted({p for s0, s1, _ in spans for p in (s0, s1)})
    owner = []
    for a, b in zip(points, points[1:]):
        best = None
        for s0, s1, name in spans:
            if s0 <= a and b <= s1 and (best is None or (s0, -s1) > (best[0], -best[1])):
                best = (s0, s1, name)
        owner.append(best[2] if best else None)
    return points, owner


def idle_us_by_span(trace) -> dict | None:
    """{span name (the stage, without the prefix) or None: idle us over the
    traced window}, every span of the trace present (0 where the device
    never idled under it); None without a trace or without any span."""
    if trace is None:
        return None
    spans = [(ts, ts + dur, name[len(PREFIX):]) for name, ts, dur in trace.host_ops if name.startswith(PREFIX)]
    if not spans:
        return None
    out = {name: 0.0 for _, _, name in spans}
    out[None] = 0.0
    points, owner = _segments(spans)
    for a, b in idle_intervals(trace):
        k = max(bisect.bisect_right(points, a) - 1, 0)
        x = a
        while x < b:
            if x < points[0]:
                y, who = min(b, points[0]), None
            elif k >= len(owner):
                y, who = b, None
            else:
                y, who = min(b, points[k + 1]), owner[k]
                k += y == points[k + 1]
            out[who] += y - x
            x = y
    return out


def idle_ms(run, names) -> float | None:
    """Mean idle ms a frame under the spans `names` (None among them: under
    no span); None when the trace has none of them."""
    split = idle_us_by_span(run.trace)
    if split is None or not any(n in split for n in names if n is not None):
        return None
    return sum(split.get(n, 0.0) for n in names) * 1e-3 / run.trace.frames
