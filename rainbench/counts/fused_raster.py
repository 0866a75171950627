"""The least work of the raster+composite launch of one render step,
from the step's inputs alone (never the program's ladder or kernel).

Bytes: the five float32 planes of every frame written once, and each
valid drop's record read once (its 16 fields of 4 bytes and its 8-byte
texture pick).

Operations: every pixel of every valid drop's window inside the frame,
the window as the reference sizes it (the content box plus the blur's
spill, floor(4 sigma + 0.5), on each side), at the cost of the cheapest
series the model evaluates a pixel with: 12 row and 6 column modes of 3
ranks, 5 operations a mode and axis a rank past the first, 2 a rank,
and 70 for the warp and its divide, two cosines, the tanh-erf window,
the clip and cutoff and the plane contributions (a transcendental
counts as one).
"""

from __future__ import annotations

import torch

from rainbench.reference import streaks

NAME = "fused_raster_kernel"
# The program's count of the kernel's launches.
COUNTER = "raintpu_torch.ops.fused_raster.fused_raster_composite"
PLANES = 5
PLANE_BYTES = 4
DROP_BYTES = 16 * 4 + 8
OPS_PER_PX = 5 * 3 * (12 + 6 - 2) + 2 * 3 + 70


def count(step) -> tuple:
    """(operations, bytes) of one step's launch; ``step`` has the
    step's ``drops``, ``settings``, ``image_hw`` and ``tex_hw``."""
    h, w = step.image_hw
    d = step.drops
    g = streaks.geometry(d, step.tex_hw, (w, h),
                         focal_m=float(step.settings["cam_focal"]) / 1000.0,
                         f_number=float(step.settings["cam_f_number"]))
    nw, nh, _ = streaks.needs(g)
    spill = torch.floor(4.0 * g.sigma + 0.5)
    x0 = g.min_c[..., 0] - spill
    y0 = g.min_c[..., 1] - spill
    cols = torch.clamp(torch.clamp_max(x0 + nw, w) - torch.clamp_min(x0, 0),
                       min=0)
    rows = torch.clamp(torch.clamp_max(y0 + nh, h) - torch.clamp_min(y0, 0),
                       min=0)
    valid = d["valid"]
    px = float(torch.where(valid, rows * cols, 0.0).double().sum())
    frames = valid.shape[0]
    return (px * OPS_PER_PX,
            frames * PLANES * h * w * PLANE_BYTES
            + int(valid.sum()) * DROP_BYTES)
