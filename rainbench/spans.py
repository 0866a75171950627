"""The program's stage spans, read from its own record: the host ms a
render step spent inside one span, over the window's untraced steps
(``raintpu_torch.utils.profiling.stage_ms``, the ring of spans the
render path keeps in memory). The traced steps open the window, so the
untraced ones are its last ``len(step_s) - profiled_steps`` render
steps. A run on the CPU, or of a program that keeps no such ring or
opened no such span, reads nothing."""

from __future__ import annotations

import statistics
from typing import Optional


def host_ms(run, name: str) -> Optional[float]:
    """The median over the untraced steps of the host ms inside span
    ``name``."""
    if run.device_name == "cpu":
        return None
    try:
        from raintpu_torch.utils.profiling import stage_ms
    except ImportError:
        return None
    steps = len(run.step_s) - run.profiled_steps
    ms = stage_ms(name, steps) if steps > 0 else []
    return statistics.median(ms) if ms else None
