"""The drop-independent half of the render: fog (Weber et al. 2015)
and the single-image environment map (Cameron 2005 style).

Fog: extinction exp(-0.312 R^0.67 depth_km), Henyey-Greenstein
in-scattering at 90 degrees with g = 0.97 of each frame's mean
irradiance 4 N^2 I / (t_exp gain pi), both blurred by the 25-tap
sigma-25 Gaussian: L = clip(I * blur(f_ext) + blur(L_in), 0, 1).

Envmap: every pixel of the (H, 2 * cylinder width) map reads one source
pixel of the frame through the cylindrical projection (rows clamped:
hole filling; columns mirrored at both ends), and pixels the frame does
not cover take the 15-tap feather of the map. The index map is worked
out on the CPU in float32 and moved to the device.
"""

from __future__ import annotations

import math

import torch

from rainbench.reference.blur import (blur_channels_last, blur_hw,
                                      gaussian_kernel)

HG_G = 0.97
FOG_KSIZE, FOG_SIGMA = 25, 25.0
FEATHER_KSIZE = 15
FEATHER_SIGMA = 0.3 * ((FEATHER_KSIZE - 1) * 0.5 - 1.0) + 0.8


def fog(image: torch.Tensor, depth: torch.Tensor, *, fallrate: float,
        f_number: float, exposure_s: float, gain: float) -> torch.Tensor:
    """image (B, H, W, 3), depth (B, H, W) in m -> the fogged frames."""
    b_ext = 0.312 * float(fallrate) ** 0.67
    f_ext = torch.exp((-b_ext) * (depth / 1000.0))
    irr = (4.0 * f_number ** 2 * image) / (exposure_s * gain * math.pi)
    cos_a = math.cos(math.radians(90.0))
    hg = (1.0 - HG_G ** 2) / (4.0 * math.pi * (1.0 + HG_G ** 2
                                              - 2.0 * HG_G * cos_a) ** 1.5)
    c = hg * irr.mean(dim=(-3, -2))
    l_in = torch.clamp(c[..., :, None, None] * (1.0 - f_ext)[..., None, :, :],
                       0.0, 1.0)
    stacked = torch.cat([f_ext[..., None, :, :], l_in], dim=-3)
    h, w = stacked.shape[-2:]
    blurred = blur_hw(stacked.reshape(-1, h, w),
                      gaussian_kernel(FOG_KSIZE, FOG_SIGMA)
                      ).reshape(stacked.shape)
    return torch.clamp(image * blurred[..., 0, :, :, None]
                       + torch.movedim(blurred[..., 1:, :, :], -3, -1),
                       0.0, 1.0)


def avg_pool(img: torch.Tensor, ds: int) -> torch.Tensor:
    """Block means of the (H, W) axes of (..., H, W, C); a partial
    trailing block is dropped."""
    if ds <= 1:
        return img
    h, w, c = img.shape[-3:]
    hq, wq = (h // ds) * ds, (w // ds) * ds
    x = img[..., :hq, :wq, :].reshape(img.shape[:-3]
                                      + (h // ds, ds, wq // ds, ds, c))
    return (x * (1.0 / ds)).sum(-4).mean(-2)


def envmap_indices(h: int, w: int, focal_mm: float):
    """(src_row, src_col, covered), each (H, W_env), on the CPU."""
    f_env = int((focal_mm / 12.7) * w)
    cx, cy = w // 2, h // 2
    max_x = round(f_env * math.atan(cx / f_env) + cx)
    min_x = round(f_env * math.atan(-cx / f_env) + cx)
    cyl = int(max_x - min_x) + 1
    border = cyl // 2
    c_total = torch.arange(cyl + 2 * border)
    cyl_col = torch.where(
        c_total < border, border - 1 - c_total,
        torch.where(c_total >= 3 * border,
                    (cyl - 1) - (c_total - 3 * border), c_total - border))
    f = float(f_env)
    dc = f * torch.tan((cyl_col.to(torch.float32) + int(min_x) - cx) / f)
    src_c = torch.round(dc + cx).to(torch.int64)
    r = torch.arange(h, dtype=torch.float32)
    dr = (r[:, None] - cy) * torch.sqrt(dc[None, :] ** 2 + f * f) / f
    src_r = torch.round(dr + cy).to(torch.int64)
    covered = ((src_r >= 0) & (src_r <= h - 1)
               & (src_c >= 0)[None, :] & (src_c <= w - 1)[None, :])
    return (torch.clamp(src_r, 0, h - 1),
            torch.clamp(src_c, 0, w - 1)[None, :].expand(src_r.shape),
            covered)


def envmap(frames: torch.Tensor, focal_mm: float) -> torch.Tensor:
    """Frames (B, H, W, 3) -> envmaps (B, H, W_env, 3)."""
    h, w = frames.shape[-3:-1]
    src_r, src_c, covered = (t.to(frames.device)
                             for t in envmap_indices(h, w, focal_mm))
    env = frames[..., src_r, src_c, :]
    blurred = blur_channels_last(env, gaussian_kernel(FEATHER_KSIZE,
                                                      FEATHER_SIGMA))
    return torch.where(covered[..., None], env, blurred)
