"""Per-drop colour from the environment map: the spherical-cone field
of view of each drop, its solid-angle-weighted mean chromaticity and
luminance, and the resulting RGB gain.

A drop at p (the streak's mid-point, axes swapped to (x, z, y)) sees
the envmap pixels whose point R * d on the sphere of radius R = 10 m
lies inside the cone of axis p/|p| and half-angle 82.5 degrees. Pixel
solid angles come from L'Huillier's theorem over two spherical
triangles a pixel; colours are CIE-1931 RGB (not sRGB) through xyY.
The luminance is 0.94 * the in-cone luminance over the whole map's
solid angle + 0.06 * the map's ambient luminance ('ambient').
"""

from __future__ import annotations

import math

import torch

RGB2XYZ = ((0.49000, 0.31000, 0.20000),
           (0.17697, 0.81240, 0.01063),
           (0.00000, 0.01000, 0.99000))
XYZ2RGB = ((0.41847, -0.15866, -0.082835),
           (-0.091169, 0.25243, 0.015708),
           (0.0009209, -0.0025498, 0.1786))
FACTOR = 0.17697
GRAY_TO_Y = (RGB2XYZ[0][1] + RGB2XYZ[1][1] + RGB2XYZ[2][1]) / FACTOR
SPHERE_RADIUS = 10.0
FOV_DEG = 165.0
# Drops a cone-mask chunk takes when frames x pixels x drops is large.
MAX_MASK_ELEMS = 64_000_000
CHUNK = 256


def rgb_to_xyY(rgb: torch.Tensor) -> torch.Tensor:
    mat = torch.tensor(RGB2XYZ, dtype=rgb.dtype, device=rgb.device)
    xyz = (rgb @ mat) / FACTOR
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    safe = s != 0
    s1 = torch.where(safe, s, torch.ones_like(s))
    return torch.stack([torch.where(safe, xyz[..., 0] / s1, 0.0),
                        torch.where(safe, xyz[..., 1] / s1, 0.0),
                        xyz[..., 1]], dim=-1)


def basis_rgb(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RGB of chromaticity (x, y) at unit luminance."""
    yy = torch.ones_like(x)
    X = (yy * x) / y
    Z = (yy * (1.0 - x - y)) / y
    mat = torch.tensor(XYZ2RGB, dtype=x.dtype, device=x.device)
    return torch.stack([X, yy, Z], dim=-1) @ mat


def _latlong(u, v):
    theta = math.pi * (2.0 * u - 1.0)
    phi = math.pi * v
    return torch.stack([torch.sin(phi) * torch.sin(theta), torch.cos(phi),
                        -torch.sin(phi) * torch.cos(theta)], dim=-1)


def _triangle(a, b, c):
    ta = torch.arccos(torch.clamp((b * c).sum(-1), -1.0, 1.0))
    tb = torch.arccos(torch.clamp((a * c).sum(-1), -1.0, 1.0))
    tc = torch.arccos(torch.clamp((a * b).sum(-1), -1.0, 1.0))
    ts = (ta + tb + tc) / 2.0
    p = (torch.tan(ts / 2.0) * torch.tan((ts - ta) / 2.0)
         * torch.tan((ts - tb) / 2.0) * torch.tan((ts - tc) / 2.0))
    return 4.0 * torch.arctan(torch.sqrt(torch.clamp_min(p, 0.0)))


def solid_angles(h: int, w: int, device) -> torch.Tensor:
    cols = torch.linspace(0.0, 1.0, w + 1, device=device)
    rows = torch.linspace(0.0, 1.0, h + 1, device=device)
    v, u = torch.meshgrid(rows, cols, indexing="ij")
    d = _latlong(u, v)
    return (_triangle(d[:-1, :-1], d[:-1, 1:], d[1:, :-1])
            + _triangle(d[:-1, 1:], d[1:, :-1], d[1:, 1:]))


def pixel_directions(h: int, w: int, device) -> torch.Tensor:
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    az = torch.remainder(1.5 * math.pi - 2.0 * math.pi * uu, 2.0 * math.pi)
    el = (1.0 - vv) * math.pi - 0.5 * math.pi
    ce = torch.cos(el)
    return torch.stack([ce * torch.cos(az), ce * torch.sin(az),
                        torch.sin(el)], dim=-1)


def _cone_sums(p, n, dirs, feats, cos_t, r):
    d0, d1, d2 = (dirs[:, k][:, None] for k in range(3))
    nt = n[..., None, :, :]
    pt = p[..., None, :, :]
    dn = d0 * nt[..., 0] + d1 * nt[..., 1] + d2 * nt[..., 2]
    dp = d0 * pt[..., 0] + d1 * pt[..., 1] + d2 * pt[..., 2]
    s = r * dn - (p * n).sum(-1)[..., None, :]
    w2 = r * r - 2.0 * r * dp + (p * p).sum(-1)[..., None, :]
    inside = (s >= 0) & (s * s >= (cos_t * cos_t) * w2)
    return torch.matmul(inside.to(feats.dtype).transpose(-1, -2), feats)


def drop_gains(env: torch.Tensor, world_mid: torch.Tensor,
               downsample: int = 1) -> torch.Tensor:
    """env (B, He, We, 3) at the photometry resolution, world_mid
    (B, N, 3) -> per-drop RGB gains (B, N, 3). With ``downsample`` > 1
    the cone test runs on blocks of pixels: their features summed, their
    directions averaged and renormalised."""
    h, w = env.shape[-3:-1]
    lead = env.shape[:-3]
    dev = env.device
    xyY = rgb_to_xyY(env)
    sa = solid_angles(h, w, dev)
    dirs = pixel_directions(h, w, dev)
    total = sa.sum()
    ambient = (xyY[..., 2] * sa).sum(dim=(-2, -1)) / total
    feats = torch.cat([xyY * sa[..., None],
                       sa[..., None].expand(lead + (h, w, 1))], dim=-1)
    if downsample > 1:
        ds = downsample
        hq, wq = (h // ds) * ds, (w // ds) * ds
        feats = feats[..., :hq, :wq, :].reshape(
            lead + (hq // ds, ds, wq // ds, ds, 4)).sum(dim=(-4, -2))
        d = dirs[:hq, :wq].reshape(hq // ds, ds, wq // ds, ds, 3).mean(
            dim=(1, 3))
        dirs = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    feats = feats.reshape(lead + (-1, 4))
    dirs = dirs.reshape(-1, 3)

    p = torch.stack([world_mid[..., 0], world_mid[..., 2],
                     world_mid[..., 1]], dim=-1)
    n = p / torch.clamp_min(torch.sqrt((p * p).sum(-1, keepdim=True)), 1e-12)
    cos_t = torch.cos(torch.deg2rad(torch.tensor(FOV_DEG / 2.0, device=dev)))
    nd = p.shape[-2]
    if p.shape[0] * dirs.shape[0] * nd <= MAX_MASK_ELEMS or nd <= CHUNK:
        sums = _cone_sums(p, n, dirs, feats, cos_t, SPHERE_RADIUS)
    else:
        sums = torch.cat([_cone_sums(p[..., i:i + CHUNK, :],
                                     n[..., i:i + CHUNK, :], dirs, feats,
                                     cos_t, SPHERE_RADIUS)
                          for i in range(0, nd, CHUNK)], dim=-2)
    covered = sums[..., 3] > 1e-9
    sa_in = torch.where(covered, sums[..., 3], torch.ones_like(sums[..., 3]))
    xy = torch.where(covered[..., None], sums[..., :2] / sa_in[..., None],
                     1.0 / 3.0)
    lum = torch.where(covered, sums[..., 2] / total, 0.0)
    bad = xy[..., 1] < 1e-6
    fx = torch.where(bad, 1.0 / 3.0, xy[..., 0])
    fy = torch.where(bad, 1.0 / 3.0, xy[..., 1])
    drop_y = 0.94 * lum + 0.06 * ambient[..., None]
    return basis_rgb(fx, fy) * (GRAY_TO_Y * drop_y)[..., None]
