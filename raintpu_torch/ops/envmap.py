"""Single-image environment-map extrapolation (Cameron 2005 style).

Counterpart of ``raintpu.ops.envmap``. The reference scatters image
pixels into a cylindrical canvas, fills holes per column, mirror-extends
left/right and feathers uncovered pixels with a 15x15 blur. As in the
JAX package the mapping is inverted — each envmap pixel (R, C) reads
one source pixel through :func:`_source_indices` (row clamping is the
reference's hole filling, mirror extension is column arithmetic) and
the feather becomes where(covered, value, blur(value)).

The JAX package evaluates that index map as one-hot matmuls only
because large gathers are slow on a TPU; here it is a gather with the
same indices, so the values are identical.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur

FEATHER_KSIZE = 15
# cv2.GaussianBlur(..., (15,15), 0) derives sigma = 0.3*((15-1)*0.5 - 1) + 0.8
FEATHER_SIGMA = 0.3 * ((FEATHER_KSIZE - 1) * 0.5 - 1.0) + 0.8


@dataclasses.dataclass(frozen=True)
class EnvmapGeometry:
    """Static geometry of the envmap for a given (H, W, focal_mm)."""

    height: int          # = image height
    width: int           # source image width
    focal_env: int       # reference: int((focal_mm / 12.7) * width)
    cyl_width: int       # int(max_x - min_x) + 1
    min_x: int
    border: int          # cyl_width // 2 mirrored on each side

    @property
    def env_width(self) -> int:
        return self.cyl_width + 2 * self.border

    @property
    def env_shape(self):
        return (self.height, self.env_width)


def envmap_geometry(height: int, width: int,
                    focal_mm: float) -> EnvmapGeometry:
    """Static envmap dims; ``focal_env = int((focal_mm/12.7)*W)``."""
    focal_env = int((focal_mm / 12.7) * width)
    cx = width // 2
    max_x = round(focal_env * math.atan(cx / focal_env) + cx)
    min_x = round(focal_env * math.atan(-cx / focal_env) + cx)
    cyl_width = int(max_x - min_x) + 1
    return EnvmapGeometry(
        height=height, width=width, focal_env=focal_env,
        cyl_width=cyl_width, min_x=int(min_x), border=cyl_width // 2)


_index_cache = {}


def _source_indices(geom: EnvmapGeometry, device="cpu",
                    dtype=torch.float32):
    """Per-envmap-pixel source (row, col) + coverage mask, each
    (H, W_env); indices int64, clamped in-bounds.

    The map is computed on the CPU, once per geometry and dtype, and
    kept on each device it is asked for: a card's tan and sqrt round
    differently, which moves an index whose coordinate sits at a
    rounding boundary by a pixel, so every device reads the pixels the
    CPU's map reads."""
    key = (geom, str(device), dtype)
    if key not in _index_cache:
        _index_cache[key] = tuple(
            t.to(device) for t in _host_source_indices(geom, dtype))
    return _index_cache[key]


def _host_source_indices(geom: EnvmapGeometry, dtype):
    """:func:`_source_indices` on the CPU."""
    h, w = geom.height, geom.width
    cx, cy = w // 2, h // 2
    f = float(geom.focal_env)

    # Column map through mirror extension -> cylinder column.
    c_total = torch.arange(geom.env_width)
    b, wc = geom.border, geom.cyl_width
    cyl_col = torch.where(
        c_total < b, b - 1 - c_total,
        torch.where(c_total >= 3 * b, (wc - 1) - (c_total - 3 * b),
                    c_total - b))

    dc = f * torch.tan((cyl_col.to(dtype) + geom.min_x - cx) / f)
    src_c = torch.round(dc + cx).to(torch.int64)            # (W_env,)

    r = torch.arange(h, dtype=dtype)
    dr = (r[:, None] - cy) * torch.sqrt(dc[None, :] ** 2 + f * f) / f
    src_r = torch.round(dr + cy).to(torch.int64)            # (H, W_env)

    covered = ((src_r >= 0) & (src_r <= h - 1)
               & (src_c >= 0)[None, :] & (src_c <= w - 1)[None, :])
    src_r = torch.clamp(src_r, 0, h - 1)
    src_c = torch.clamp(src_c, 0, w - 1)
    return src_r, src_c[None, :].expand(src_r.shape), covered


def generate_envmap(background: torch.Tensor,
                    geom: EnvmapGeometry) -> torch.Tensor:
    """Image (..., H, W, 3) in [0,1] -> envmap (..., H, W_env, 3)."""
    src_r, src_c, covered = _source_indices(geom, background.device,
                                            background.dtype)
    env = background[..., src_r, src_c, :]
    kernel = cv2_gaussian_kernel(FEATHER_KSIZE, FEATHER_SIGMA)
    blurred = separable_blur(env, kernel)
    return torch.where(covered[..., None], env, blurred)
