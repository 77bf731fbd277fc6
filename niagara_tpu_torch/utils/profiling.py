"""Frame timing (niagara_tpu/utils/profiling.py): EWMAs of frame and span
times and a HUD-style report, and per-stage times and counts of chained
frames (`StageTimer`, the counterpart of the reference's tools/profile_*.py
prefix timing) whose stages `span` also puts on a running torch.profiler's
trace.

On a CUDA device the frame and its spans are timed by CUDA events and
the frame's end waits for the device: the host returns from a frame long
before the card has run it, so a host clock around it would time the
enqueue, not the work.  `StageTimer` waits only once, after the frames."""

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


class StageTimer:
    """Per-stage times and counts of chained frames, without synchronizing
    inside them (the counterpart of tools/profile_frame.py's prefix timing).

    `begin()` opens a frame; `mark(name)` closes the stage `name`, which
    ran since the previous boundary (`span` marks at its exit).  Each
    boundary records a CUDA event (on a CUDA device) and the host's
    perf_counter; `resolve()` waits for the device once and returns, per
    frame, each stage's device-timeline ms (between its boundary events)
    and host enqueue ms (between its perf_counter reads).  On the CPU both
    columns are the host clock.

    A host-bound frame's device timeline includes the device waiting for
    the host's launches: a stage's device ms is when the device finished
    it minus when it finished the one before, idle included.  Each column
    telescopes to its frame's ms (first boundary to last).

    `count(name, value, base)` records a device count against its base (a
    budget, or what the count is taken over) without reading it: a frame's
    counts are copied into one small row of their own by one device op
    when the next frame begins (or at `resolve`), so no frame's buffers
    outlive it."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._frames = []
        self._counts = []  # per frame: (row or None, [(name, entries, bases)])
        self._pending = []  # the open frame's (name, value, bases)

    def _boundary(self, name):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._frames[-1].append((name, ev, time.perf_counter()))

    def _flush(self):
        if self._pending:
            values = [v.reshape(-1) for _, v, _ in self._pending]
            self._counts[-1] = (torch.cat(values), [(n, v.numel(), b) for (n, _, b), v in zip(self._pending, values)])
            self._pending = []

    def begin(self):
        self._flush()
        self._frames.append([])
        self._counts.append((None, []))
        self._boundary(None)

    def mark(self, name: str):
        self._boundary(name)

    def count(self, name: str, value: torch.Tensor, base):
        """Count `value` (a device tensor of k entries) against `base` (k
        numbers, or one for k = 1) in the open frame; a name counted twice
        in a frame adds up."""
        bases = tuple(base) if isinstance(base, (tuple, list)) else (base,)
        if value.numel() != len(bases):
            raise ValueError(f"StageTimer.count {name!r}: {value.numel()} entries against {len(bases)} bases")
        self._pending.append((name, value, bases))

    def resolve(self) -> list[dict]:
        """[{"stages": [(name, device_ms, host_ms)], "device_ms", "host_ms",
        "counters": {name: (values, bases)}}] per frame, frames in order;
        waits for the device once."""
        self._flush()
        filled = [row for row, _ in self._counts if row is not None]
        flat = torch.cat(filled).tolist() if filled else []
        if self.cuda and self._frames:
            self._frames[-1][-1][1].synchronize()
        out, at = [], 0
        for marks, (_, entries) in zip(self._frames, self._counts):
            rows = []
            for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
                host = (h1 - h0) * 1000.0
                rows.append((name, e0.elapsed_time(e1) if self.cuda else host, host))
            counters = {}
            for name, k, bases in entries:
                values, at = tuple(flat[at:at + k]), at + k
                if name in counters:
                    v0, b0 = counters[name]
                    values, bases = tuple(x + y for x, y in zip(v0, values)), tuple(x + y for x, y in zip(b0, bases))
                counters[name] = (values, bases)
            (_, e0, h0), (_, e1, h1) = marks[0], marks[-1]
            out.append(dict(stages=rows, device_ms=e0.elapsed_time(e1) if self.cuda else (h1 - h0) * 1000.0,
                            host_ms=(h1 - h0) * 1000.0, counters=counters))
        return out


_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def _span(stages, name, profiled):
    with torch.profiler.record_function(f"niagara::{name}") if profiled else _NO_SPAN:
        yield
        if stages is not None:
            stages.mark(name)


def span(stages, name: str):
    """The program's stage `name` as a context: its exit is the StageTimer
    boundary `name` of `stages` (None: no boundary), and while
    torch.profiler records, the whole block is the range
    "niagara::<name>", a user annotation on the trace's clock.  With
    neither, the one shared no-op context: nothing is allocated, launched
    or recorded.  record_function is entered only under the profiler: even
    idle it costs tens of times the check."""
    profiled = torch.autograd._profiler_enabled()
    if stages is None and not profiled:
        return _NO_SPAN
    return _span(stages, name, profiled)


def stage_marker(stages):
    """`stages.mark` of a StageTimer, or a no-op for stages=None (the
    callers' default: no boundary is recorded)."""
    return stages.mark if stages is not None else (lambda name: None)


def stage_table(frames: list[dict]) -> dict:
    """Mean device and host ms of each stage over `StageTimer.resolve()`'s
    frames (a stage named twice in a frame counts twice), in the order
    the stages first ran, with the frames' mean totals."""
    table = {}
    for f in frames:
        for name, dev, host in f["stages"]:
            row = table.setdefault(name, [0.0, 0.0])
            row[0] += dev / len(frames)
            row[1] += host / len(frames)
    return dict(stages={k: dict(device_ms=v[0], host_ms=v[1]) for k, v in table.items()},
                device_ms=sum(f["device_ms"] for f in frames) / len(frames),
                host_ms=sum(f["host_ms"] for f in frames) / len(frames))
