"""A kernel's share of its roofline in a traced window: the least time
its launches could take on the card (the larger of operations over the
card's float32 peak and bytes over its memory bandwidth, from the
kernel's count in ``counts/``) over the device time the trace gives the
operations that carry the kernel's name. Where the profile lost some of
the launches the program issued (its counter), the bound is that of the
launches it kept, each taken as an equal part of the steps' work. The
peaks are the published ones (``peaks.json``); a card the table does
not hold reads nothing."""

from __future__ import annotations

import json
from typing import Optional

from rainbench import spec


def peaks(device_name: str) -> Optional[dict]:
    with open(spec.HERE / "peaks.json") as fh:
        cards = json.load(fh)["cards"]
    return next((c for c in cards if c["match"] in device_name), None)


def share(run, kernel: str) -> Optional[float]:
    """Percent of the roofline of ``kernel`` over the run's traced
    steps, or None where there is no trace, it holds no launch of the
    kernel or the card is unknown."""
    if run.view is None:
        return None
    peak = peaks(run.device_name)
    mod = spec.count(kernel)
    seconds = run.view.op_seconds(mod.NAME)
    issued = run.issued.get(kernel, 0)
    if peak is None or seconds <= 0 or issued <= 0:
        return None
    bound = 0.0
    for step in run.traced:
        ops, nbytes = mod.count(step)
        bound += max(ops / peak["fp32_flops_per_s"],
                     nbytes / peak["bytes_per_s"])
    kept = min(run.view.launches(mod.NAME), issued)
    return 100.0 * bound * kept / issued / seconds
