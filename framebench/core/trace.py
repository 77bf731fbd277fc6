"""The device trace of a few steady frames, reduced.

`profile_frames` runs frames under torch.profiler (CPU and CUDA activity),
exports the Chrome trace to a temporary directory and keeps its device
activity (kernels, copies, sets) and the host's operations.  `Trace`
answers what the per-layer readers ask: device time by kernel name, the
union of device activity, launches a frame, the longest device
operations and the longest idle gaps with what the host was doing.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list, host_ops: list, frames: int, window_s: float):
        self.events = events  # (name, cat, ts_us, dur_us), device activity, by start
        self.host_ops = host_ops  # (name, ts_us, dur_us), host operations
        self.frames = frames
        self.window_s = window_s

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the activity intervals)."""
        busy, end = 0.0, None
        for _, _, ts, dur in self.events:
            if end is None or ts > end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy * 1e-6

    def kernel_ms_per_frame(self, substring: str) -> float | None:
        """Mean device ms a frame of the kernels whose name holds
        `substring`; None when the trace has none."""
        durs = [dur for name, cat, _, dur in self.events if cat == "kernel" and substring in name]
        return sum(durs) * 1e-3 / self.frames if durs else None

    def launches_per_frame(self) -> float:
        return len(self.events) / self.frames

    def device_ops(self, n: int = 10) -> list:
        """The n device operations that took most time, in seconds."""
        total = {}
        for name, _, _, dur in self.events:
            total[name] = total.get(name, 0.0) + dur * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between device activity, each named by the
        innermost host operation running at its middle."""
        gaps, end = [], None
        for _, _, ts, dur in self.events:
            if end is not None and ts > end:
                gaps.append((ts - end, end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        out = []
        for length, a, b in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (a + b)
            inner = [(dur, name) for name, ts, dur in self.host_ops if ts <= mid <= ts + dur]
            out.append([min(inner)[1] if inner else "host", length * 1e-6])
        return out


def profile_frames(run_frame, frames: int) -> Trace:
    """`run_frame(k)` for k in range(frames) under torch.profiler; each call
    waits for its frame.  The traced window is the host's wall time over
    the calls."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="framebench-trace-") as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(frames):
                run_frame(k)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    device, host = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((e.get("name", ""), cat, float(e["ts"]), float(e["dur"])))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
    device.sort(key=lambda r: r[2])
    return Trace(device, host, frames, window_s)
