"""Order-independent photometric compositing of drops.

Counterpart of the blend side of ``raintpu.ops.composite``. The
reference blends drops sequentially; expanding the recurrence and
dropping the sparse cross terms gives

    rainy ~= exp(sum_i log f_i) * rainy_0 + sum_i add_i,
    f_i = 1 - alpha_i * lo_i,

so a frame's drops reduce to three order-independent sums (alpha,
log-attenuation, additive RGB) — the planes the fused raster+composite
kernel (:mod:`raintpu_torch.ops.fused_raster`) accumulates, and the
planes :func:`composite_drops` scatter-adds from the golden path's
rasterized patches (``raintpu.ops.composite.composite_drops``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from raintpu_torch.ops.fused_raster import LOG_EPS, N_PLANES, N_PLANES_SAT
from raintpu_torch.particles.schema import take_drops

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

    @staticmethod
    def from_planes(planes: torch.Tensor) -> "FieldMaps":
        """Views of stacked planes (..., 5 | 8, H, W) in the fused
        kernel's order (alpha, log_att, add_r, add_g, add_b[, sat_r,
        sat_g, sat_b])."""
        sat = None
        if planes.shape[-3] == N_PLANES_SAT:
            sat = torch.movedim(planes[..., 5:8, :, :], -3, -1)
        return FieldMaps(log_att=planes[..., 1, :, :],
                         additive=torch.movedim(planes[..., 2:5, :, :],
                                                -3, -1),
                         alpha=planes[..., 0, :, :], sat=sat)

    def planes(self) -> torch.Tensor:
        """The fields stacked as (..., 5 | 8, H, W) planes, the
        inverse of :meth:`from_planes`."""
        parts = [self.alpha[..., None, :, :], self.log_att[..., None, :, :],
                 torch.movedim(self.additive, -1, -3)]
        if self.sat is not None:
            parts.append(torch.movedim(self.sat, -1, -3))
        return torch.cat(parts, dim=-3)


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


# Slots a scatter chunk takes are sized so its window pixels stay at
# about this many (its value and index buffers are the planes times
# that): the JAX package's chunking, whatever the rung's patch size.
SCATTER_CHUNK_PX = 8_388_608


def _scatter_bucket(planes: torch.Tensor, patches: torch.Tensor,
                    anchor: torch.Tensor, n_slots: int, lo: torch.Tensor,
                    add_rgb: torch.Tensor,
                    sat_rgb: Optional[torch.Tensor]) -> None:
    """planes (L, P, HP, WP) += the first ``n_slots`` slots of one
    bucket's patches (L, C, PH, PW), in place.

    The planes are padded by the caller to (H + PH, W + PW), so patches
    at anchors (L, C, 2) clipped to [0, W] x [0, H] cannot leave them.
    lo (L, C), add_rgb and sat_rgb (L, C, 3) are the slots' drop rows.
    Each pixel adds p, log(max(1 - p*lo, LOG_EPS)), p*add_rgb and, with
    sat_rgb, clip(p*sat_rgb, 0, 1): one ``index_add_`` a chunk of slots.
    """
    n_fr, n_planes, hp, wp = planes.shape
    ph, pw = patches.shape[-2:]
    chunk = max(1, SCATTER_CHUNK_PX // (n_fr * ph * pw))
    dev = planes.device
    ii = torch.arange(ph, device=dev)[:, None]
    jj = torch.arange(pw, device=dev)[None, :]
    frame_base = (torch.arange(n_fr, device=dev)
                  * (n_planes * hp * wp))[:, None, None, None]
    plane_base = (torch.arange(n_planes, device=dev)
                  * (hp * wp))[:, None, None, None, None]
    flat = planes.view(-1)
    for c0 in range(0, n_slots, chunk):
        cs = slice(c0, min(c0 + chunk, n_slots))
        p = patches[:, cs]                               # (L, c, ph, pw)
        a = anchor[:, cs].to(torch.int64)
        pix = (frame_base + (a[..., 1, None, None] + ii) * wp
               + a[..., 0, None, None] + jj)             # (L, c, ph, pw)
        vals = [p, torch.log(torch.clamp_min(
            1.0 - p * lo[:, cs, None, None], LOG_EPS))]
        vals += [p * add_rgb[:, cs, k, None, None] for k in range(3)]
        if sat_rgb is not None:
            vals += [torch.clamp(p * sat_rgb[:, cs, k, None, None], 0.0,
                                 1.0) for k in range(3)]
        flat.index_add_(0, (plane_base + pix).reshape(-1),
                        torch.stack(vals).reshape(-1))


def composite_drops(image_hw: Tuple[int, int],
                    buckets: Sequence,
                    lo_all: torch.Tensor,
                    add_rgb_all: torch.Tensor,
                    sat_rgb_all: Optional[torch.Tensor] = None
                    ) -> FieldMaps:
    """Accumulate rasterized buckets (ops.rasterize.RasterBucket) into
    (..., H, W) field maps by scatter-add: the golden path's composite.

    lo_all (..., N), add_rgb_all and sat_rgb_all (..., N, 3) are
    per-frame-drop arrays; a bucket's slots take theirs through
    ``drop_idx``, and invalid slots take 0 (by where(): a degenerate
    drop's NaN must not survive as NaN * 0). With sat_rgb_all the
    saturation mask is summed too. The planes are padded by the largest
    (PH, PW) while they accumulate, then cropped to (H, W). Slots past
    the fullest frame's valid ones hold zero patches, which add exact
    zeros: they are skipped.

    The sums are float32 ``index_add_``. On CUDA it adds with atomics,
    so the order of a pixel's terms, and its last bits, can change from
    run to run; on the CPU the order is fixed.
    """
    h, w = image_hw
    lead = buckets[0].valid.shape[:-1]
    n_fr = math.prod(lead)
    hp = h + max(b.patches.shape[-2] for b in buckets)
    wp = w + max(b.patches.shape[-1] for b in buckets)
    with_sat = sat_rgb_all is not None
    n_planes = N_PLANES_SAT if with_sat else N_PLANES
    planes = torch.zeros((n_fr, n_planes, hp, wp), dtype=torch.float32,
                         device=lo_all.device)
    for b in buckets:
        valid = b.valid.reshape(n_fr, -1)
        idx = b.drop_idx.reshape(valid.shape)

        def rows(x):
            # (..., N[, 3]) -> the slots' rows (L, C[, 3]), 0 if invalid.
            got = take_drops(x.reshape((n_fr,) + x.shape[len(lead):]), idx)
            v = valid.reshape(valid.shape + (1,) * (got.ndim - 2))
            return torch.where(v, got, 0.0)

        n_slots = int(valid.sum(-1).max()) if valid.numel() else 0
        _scatter_bucket(
            planes, b.patches.reshape((n_fr,) + b.patches.shape[-3:]),
            b.anchor.reshape(valid.shape + (2,)), n_slots, rows(lo_all),
            rows(add_rgb_all), rows(sat_rgb_all) if with_sat else None)
    planes = planes[..., :h, :w].reshape(lead + (n_planes, h, w))
    return FieldMaps.from_planes(planes)


def blend(fogged: torch.Tensor, fields: FieldMaps) -> torch.Tensor:
    """Final blend: attenuate the fogged background and add drop light."""
    att = torch.exp(fields.log_att)[..., None]
    return torch.clamp(att * fogged + fields.additive, 0.0, 1.0)
