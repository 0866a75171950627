"""The traced window, reduced: the device's operations and busy time,
its idle gaps and what the host ran meanwhile.

The arithmetic is a copy of the port's ``utils/profiling.trace_summary``:
device operations are the CUDA kernels, copies and fills the profiler
recorded; the window runs from the first event's start to the last
one's end, unless the host clock timed it; busy time is the union of
the device operations' intervals; an idle gap is the stretch between
two merged busy intervals, named by the top-level host operation that
overlapped it most. Times in seconds.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

# The profiler's own bookkeeping, left out of the timeline.
PROFILER_EVENTS = ("Activity Buffer Request",)
TOP = 10
# A breakdown name is cut to this many characters.
NAME_CHARS = 120


@dataclasses.dataclass
class View:
    """A traced window of ``steps`` render steps."""

    steps: int
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]]   # (name, start_s, end_s)
    host_ops: List[Tuple[str, float, float]]     # top-level host ops

    def op_seconds(self, symbol: str) -> float:
        """Device seconds of the operations whose name holds
        ``symbol``."""
        return sum(e - s for n, s, e in self.device_ops if symbol in n)

    def launches(self, symbol: str) -> int:
        """The device operations whose name holds ``symbol``."""
        return sum(symbol in n for n, _, _ in self.device_ops)

    def top_ops(self) -> list:
        """The TOP device operations by total seconds: [name, s]."""
        total = collections.defaultdict(float)
        for n, s, e in self.device_ops:
            total[n[:NAME_CHARS]] += e - s
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, s] for n, s in ops]

    def idle_gaps(self) -> list:
        """The TOP longest idle gaps, each named by the host operation
        that overlapped it most ("idle" when none did): [name, s]."""
        busy = _merged((s, e) for _, s, e in self.device_ops)
        gaps = sorted(((a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for start, end in gaps:
            overlap = collections.defaultdict(float)
            for n, s, e in self.host_ops:
                o = min(end, e) - max(start, s)
                if o > 0:
                    overlap[n] += o
            name = max(overlap, key=overlap.get) if overlap else "idle"
            named.append([name[:NAME_CHARS], end - start])
        return named


def _merged(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def view(prof, steps: int, window_s: Optional[float] = None) -> View:
    """The :class:`View` of a finished ``torch.profiler`` profile of
    ``steps`` steps; ``window_s``, where given, is the window's length
    by the host clock."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.name not in PROFILER_EVENTS]

    def span(e):
        return e.time_range.start * 1e-6, e.time_range.end * 1e-6

    device = [(e.name,) + span(e) for e in events
              if e.device_type == DeviceType.CUDA]
    host = [(e.name,) + span(e) for e in events
            if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    if window_s is None and events:
        window_s = (max(e.time_range.end for e in events)
                    - min(e.time_range.start for e in events)) * 1e-6
    busy = sum(e - s for s, e in _merged((s, e) for _, s, e in device))
    return View(steps=steps, window_s=window_s or 0.0, busy_s=busy,
                device_ops=device, host_ops=host)
