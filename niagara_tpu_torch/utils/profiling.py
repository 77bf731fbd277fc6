"""Frame timing (niagara_tpu/utils/profiling.py): EWMAs of frame and span
times and a HUD-style report, and a `torch.profiler` trace.

On a CUDA device the frame and its spans are timed by CUDA events and
the frame's end waits for the device: the host returns from a frame long
before the card has run it, so a host clock around it would time the
enqueue, not the work."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Ewma:
    """EWMA with the reference's 0.95/0.05 blend (profiling.py:19)."""

    value: float = 0.0
    initialized: bool = False

    def update(self, sample: float) -> float:
        if not self.initialized:
            self.value = sample
            self.initialized = True
        else:
            self.value = self.value * 0.95 + sample * 0.05
        return self.value


class _Clock:
    """Milliseconds between two marks: CUDA events on a CUDA device (the
    second mark waits for the device), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, start, end) -> float:
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1000.0


@dataclass
class FrameProfiler:
    """Frame time and named span EWMAs on `device`, and the last frame's
    own time; `report` formats them with a frame's stats (profiling.py:35)."""

    device: str = "cuda"
    frame: Ewma = field(default_factory=Ewma)
    spans: dict = field(default_factory=dict)
    last_ms: float = 0.0
    _start: object = None

    def __post_init__(self):
        self._clock = _Clock(self.device)

    def begin_frame(self):
        self._start = self._clock.mark()

    def end_frame(self) -> float:
        """The frame's milliseconds, kept in `last_ms` and folded into the
        EWMA; returns the EWMA (as the reference's HUD shows it)."""
        self.last_ms = self._clock.ms(self._start, self._clock.mark())
        return self.frame.update(self.last_ms)

    @contextlib.contextmanager
    def span(self, name: str):
        start = self._clock.mark()
        try:
            yield
        finally:
            self.spans.setdefault(name, Ewma()).update(self._clock.ms(start, self._clock.mark()))

    def report(self, stats=None, triangles: int | None = None) -> str:
        lines = [f"frame: {self.frame.value:.3f} ms"]
        for name, e in self.spans.items():
            lines.append(f"  {name}: {e.value:.3f} ms")
        if stats is not None:
            lines.append("  commands E/L: %d/%d; clusters E/L: %d/%d; visible draws: %d" % (
                int(stats.early_commands), int(stats.late_commands), int(stats.early_clusters),
                int(stats.late_clusters), int(stats.visible_draws)))
            drops = (int(stats.cmd_dropped), int(stats.cluster_dropped), int(stats.tri_dropped),
                     int(stats.pair_dropped))
            if any(drops):
                lines.append("  DROPPED cmd/cluster/tri/pair: %d/%d/%d/%d" % drops)
        if triangles is not None and self.frame.value > 0:
            tri_s = triangles / (self.frame.value * 1e-3)
            lines.append(f"  {triangles / 1e6:.2f}M tri; {tri_s / 1e9:.1f}B tri/sec")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (CPU, and CUDA when available)
    written to `log_dir` as a Chrome trace (trace.json); yields the
    profiler."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
