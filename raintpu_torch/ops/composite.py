"""Order-independent photometric compositing of drops.

Counterpart of the blend side of ``raintpu.ops.composite``. The
reference blends drops sequentially; expanding the recurrence and
dropping the sparse cross terms gives

    rainy ~= exp(sum_i log f_i) * rainy_0 + sum_i add_i,
    f_i = 1 - alpha_i * lo_i,

so a frame's drops reduce to three order-independent sums (alpha,
log-attenuation, additive RGB) — the planes the fused raster+composite
kernel (:mod:`raintpu_torch.ops.fused_raster`) accumulates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

# tau_zero = sqrt(1.16e-3) / 50 — Garg-Nayar drop size constant.
DROP_SIZE = 1.16e-3
TAU_ZERO = math.sqrt(DROP_SIZE) / 50.0


@dataclasses.dataclass
class FieldMaps:
    """Accumulated drop fields over the image (leading batch dims
    allowed)."""

    log_att: torch.Tensor   # (..., H, W)  sum_i log(1 - alpha_i * lo_i)
    additive: torch.Tensor  # (..., H, W, 3) sum_i tex_i * color_i * tau1/tau0
    alpha: torch.Tensor     # (..., H, W)  sum_i alpha_i — the rain mask
    # (..., H, W, 3) sum_i clip(alpha_i * color_i, 0, 1) — the reference's
    # rainy_saturation_mask; None unless the saturation planes are on.
    sat: Optional[torch.Tensor] = None


def blend_coefficients(iw1: torch.Tensor, iw2: torch.Tensor,
                       length: torch.Tensor,
                       *,
                       exposure_s: float,
                       opacity_attenuation: float,
                       rendering_strategy
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-drop (lo, add_scale): attenuation slope and additive gain.

    Physics: lo = opacity_attenuation * d_avg / (length + d_avg) with
    d_avg = (iw1 + iw2)/2, add_scale = t_exp * lo / tau0. 'white': lo =
    1; 'naive_db': lo = d_avg / (length + d_avg).
    """
    d_avg = (iw1 + iw2) / 2.0
    lf = length.to(d_avg.dtype)
    if rendering_strategy == "white":
        lo = torch.ones_like(d_avg)
    elif rendering_strategy == "naive_db":
        lo = d_avg / (lf + d_avg)
    else:
        lo = opacity_attenuation * d_avg / (lf + d_avg)
    add_scale = exposure_s * lo / TAU_ZERO
    return lo, add_scale


def blend(fogged: torch.Tensor, fields: FieldMaps) -> torch.Tensor:
    """Final blend: attenuate the fogged background and add drop light."""
    att = torch.exp(fields.log_att)[..., None]
    return torch.clamp(att * fogged + fields.additive, 0.0, 1.0)
