"""The card beside the window: its name and power limit, and its SM
clock and power draw sampled by ``nvidia-smi`` while the window runs,
so that a run that reads slow can be told from one whose card slowed."""

from __future__ import annotations

import statistics
import subprocess

PERIOD_MS = 500


def name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or
    "unknown"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _spread(values) -> list:
    return [min(values), statistics.median(values), max(values)]


class Sampler:
    """Samples card ``index`` every PERIOD_MS from construction to
    :meth:`stop`."""

    def __init__(self, index: int):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--id={index}",
                 "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", f"--loop-ms={PERIOD_MS}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        """Ends the sampler and waits for it. Returns the number of
        samples and the [min, median, max] of the SM clock (MHz) and of
        the power draw (W)."""
        if self.proc is None:
            return {"samples": 0}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        mhz, watts = [], []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                m, w = float(parts[0]), float(parts[1])
            except (ValueError, IndexError):
                continue
            mhz.append(m)
            watts.append(w)
        if not mhz:
            return {"samples": 0}
        return {"samples": len(mhz), "sm_mhz": _spread(mhz),
                "power_w": _spread(watts)}
