"""Console logging and progress utilities.

The port's copy of ``raintpu.utils.logging``: the ANSI-tagged messages
(reference ``my_utils.py:22-31``), the progress bar (``my_utils.py:34-52``),
natural file ordering (``my_utils.py:19-20``) and the nested progress
line with its remaining-time estimate (``my_utils.py:100-134``). The
render path's stage times are ``utils.profiling``'s spans.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
import time
from typing import List, Optional


def print_error(msg: str) -> None:
    print(f"\n\x1b[2;30;41m[ERROR]\x1b[0m  {msg}")


def print_success(msg: str) -> None:
    print(f"\n\x1b[2;30;42m[SUCCESS]\x1b[0m  {msg}")


def print_warning(msg: str) -> None:
    print(f"\x1b[2;30;43m[WARNING]\x1b[0m  {msg}")


def progress_bar(iteration: int, total: int, prefix: str = "Progress:",
                 suffix: str = "Complete", length: int = 60) -> None:
    frac = iteration / float(max(total, 1))
    filled = int(length * iteration // max(total, 1))
    bar = "#" * filled + "-" * (length - filled)
    sys.stdout.write(f"\r{prefix} |{bar}| {100 * frac:.2f}% {suffix}")
    if iteration >= total:
        print()


def natural_sorted(names):
    """Natural ('human') sort — the reference uses natsort for frame
    file ordering."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", str(s))]
    return sorted(names, key=key)


def natural_listdir(path: str):
    return natural_sorted(os.listdir(path))


@dataclasses.dataclass
class _Level:
    name: str
    index: int = 0
    total: int = 1
    t0: float = 0.0


class ProgressScope:
    """Nested progress tracking with per-level remaining-time estimates.

    Levels mirror the reference's sequence/weather/frame hierarchy:

        prog = ProgressScope(["seq", "weather", "frame"])
        prog.start("seq", total=3)
        prog.update("seq", 0); ... ; print(prog.line())
    """

    def __init__(self, level_names: List[str]):
        self.levels = [_Level(n, t0=time.time()) for n in level_names]
        self._by_name = {lv.name: lv for lv in self.levels}
        self.t_start = time.time()

    def start(self, name: str, total: int) -> None:
        lv = self._by_name[name]
        lv.total = max(int(total), 1)
        lv.index = 0
        lv.t0 = time.time()

    def update(self, name: str, index: int) -> None:
        self._by_name[name].index = index

    def _progress(self) -> float:
        """Fractional progress compounded across levels."""
        frac = 0.0
        for lv in reversed(self.levels):
            frac = (lv.index + frac) / lv.total
        return frac

    def eta_s(self) -> Optional[float]:
        p = self._progress()
        if p <= 0:
            return None
        return (1.0 - p) * (time.time() - self.t_start) / p

    def line(self) -> str:
        parts = [f"{lv.name[0].upper()}. {lv.index + 1}/{lv.total}"
                 for lv in self.levels]
        eta = self.eta_s()
        eta_str = f"{eta // 60:02.0f}m" if eta is not None else "--"
        return "  ".join(parts) + f"   >  ETA {eta_str}"

