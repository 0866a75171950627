"""Volumetric fog-like rain attenuation (Weber et al. 2015 model).

Counterpart of ``raintpu.ops.fog``: given a clear image and per-pixel
depth, apply extinction + Henyey-Greenstein in-scattering:

    beta_ext = 0.312 * R^0.67
    f_ext    = exp(-beta_ext * depth_km)
    E        = 4 N^2 I / (t_exp * gain * pi)
    beta_hg  = (1-g^2) / (4 pi (1+g^2-2g cos a)^1.5),  g = 0.97
    L_in     = clip(beta_hg * mean(E) * (1 - f_ext), 0, 1)
    L        = clip(I * blur(f_ext) + blur(L_in), 0, 1)

with the reference's 25x25 sigma-25 Gaussian as ``blur``, run as one
channel-major 4-channel blur of [f_ext, L_in_rgb] through
:func:`raintpu_torch.ops.blur_kernel.separable_blur` — the stencil
kernel on a CUDA card, the band-matrix products on the CPU.
"""

from __future__ import annotations

import math

import torch

from raintpu_torch.ops.blur import cv2_gaussian_kernel
from raintpu_torch.ops.blur_kernel import separable_blur

HG_G = 0.97
FOG_BLUR_KSIZE = 25
FOG_BLUR_SIGMA = 25.0


def beta_ext(rain_intensity) -> float:
    """Extinction coefficient (km^-1) for fall rate R (mm/hr)."""
    return 0.312 * float(rain_intensity) ** 0.67


def beta_hg(angle_deg: float, g: float = HG_G) -> float:
    """Henyey-Greenstein phase (Weber 2015 eq. 10)."""
    cos_term = math.cos(math.radians(angle_deg))
    return (1.0 - g ** 2) / (4.0 * math.pi *
                             (1.0 + g ** 2 - 2.0 * g * cos_term) ** 1.5)


def fog_rain_layer(image: torch.Tensor,
                   depth: torch.Tensor,
                   *,
                   rain_intensity: float,
                   f_number: float,
                   exposure_s: float,
                   camera_gain: float,
                   angle_deg: float = 90.0) -> torch.Tensor:
    """Apply fog-like rain attenuation. image (..., H, W, 3) in [0, 1];
    depth (..., H, W) in m. The mean irradiance is taken per frame."""
    b_ext = beta_ext(rain_intensity)
    f_ext = torch.exp((-b_ext) * (depth / 1000.0))         # (..., H, W)

    irr = (4.0 * f_number ** 2 * image) / (exposure_s * camera_gain * math.pi)
    irr_mean = irr.mean(dim=(-3, -2))                      # (..., 3)

    c = beta_hg(angle_deg) * irr_mean                      # (..., 3)
    l_in = torch.clamp(c[..., :, None, None]
                       * (1.0 - f_ext)[..., None, :, :], 0.0, 1.0)

    kernel = cv2_gaussian_kernel(FOG_BLUR_KSIZE, FOG_BLUR_SIGMA)
    # One 4-channel blur: [f_ext, l_in_rgb]; the reference blurs a
    # 3-channel broadcast of f_ext, which one channel reproduces.
    stacked = torch.cat([f_ext[..., None, :, :], l_in], dim=-3)
    h, w = stacked.shape[-2:]
    blurred = separable_blur(stacked.reshape(-1, h, w),
                             kernel).reshape(stacked.shape)
    f_ext_b = blurred[..., 0, :, :]                        # (..., H, W)
    l_in_b = torch.movedim(blurred[..., 1:, :, :], -3, -1)  # (..., H, W, 3)

    return torch.clamp(image * f_ext_b[..., None] + l_in_b, 0.0, 1.0)
