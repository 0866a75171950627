"""CIE-1931 RGB <-> xyY color conversions (PyTorch).

Counterpart of ``raintpu.ops.color``: the reference's CIE 1931 RGB
primaries (not sRGB) with the 1/0.17697 normalization, on tensors with
a trailing channel dimension of 3. xyY -> RGB is linear in Y, so a
drop's color factors as ``gray(px) * luminance_gain * base_rgb(x, y)``
(:func:`xyY_basis_rgb`).
"""

from __future__ import annotations

import functools

import torch

# XYZ_j = sum_k rgb_k * RGB2XYZ[k, j] / FACTOR
RGB2XYZ = (
    (0.49000, 0.31000, 0.20000),
    (0.17697, 0.81240, 0.01063),
    (0.00000, 0.01000, 0.99000),
)
FACTOR = 0.17697

# rgb_j = sum_k XYZ_k * XYZ2RGB[k, j]
XYZ2RGB = (
    (0.41847, -0.15866, -0.082835),
    (-0.091169, 0.25243, 0.015708),
    (0.0009209, -0.0025498, 0.1786),
)

# Luminance of a gray pixel g (r=g=b=g): Y = g * sum(RGB2XYZ[:,1]) / FACTOR.
GRAY_TO_Y = (RGB2XYZ[0][1] + RGB2XYZ[1][1] + RGB2XYZ[2][1]) / FACTOR


@functools.lru_cache(maxsize=None)
def device_constant(value, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, made once per
    (value, dtype, device) and shared by every caller, who must not
    write to it: a copy from the host to a CUDA device waits for its
    stream, and a CUDA graph cannot capture one."""
    return torch.tensor(value, dtype=dtype, device=device)


def rgb_to_xyY(rgb: torch.Tensor, nan_to_zero: bool = True) -> torch.Tensor:
    """RGB -> xyY. Shape (..., 3) -> (..., 3) with channels (x, y, Y).

    x = X/(X+Y+Z) is NaN for black pixels; with ``nan_to_zero`` (the
    reference's call-site replacement) those chromaticities are 0.
    """
    mat = device_constant(RGB2XYZ, rgb.dtype, rgb.device)
    xyz = (rgb @ mat) / FACTOR
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    if nan_to_zero:
        safe = s != 0
        s_safe = torch.where(safe, s, torch.ones_like(s))
        x = torch.where(safe, xyz[..., 0] / s_safe, 0.0)
        y = torch.where(safe, xyz[..., 1] / s_safe, 0.0)
    else:
        x = xyz[..., 0] / s
        y = xyz[..., 1] / s
    return torch.stack([x, y, xyz[..., 1]], dim=-1)


def xyY_to_rgb(xyY: torch.Tensor) -> torch.Tensor:
    """xyY -> RGB. Shape (..., 3) -> (..., 3)."""
    x, y, Y = xyY[..., 0], xyY[..., 1], xyY[..., 2]
    X = (Y * x) / y
    Z = (Y * (1.0 - x - y)) / y
    mat = device_constant(XYZ2RGB, xyY.dtype, xyY.device)
    return torch.stack([X, Y, Z], dim=-1) @ mat


def xyY_basis_rgb(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RGB of chromaticity (x, y) at unit luminance, (..., 3)."""
    return xyY_to_rgb(torch.stack([x, y, torch.ones_like(x)], dim=-1))
