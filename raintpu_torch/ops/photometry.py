"""Per-drop environment lighting: spherical-cone FOV photometry.

Counterpart of ``raintpu.ops.photometry``. A drop's field of view is
the set of envmap pixels whose sphere point P = R*d lies inside the
cone with apex at the drop position p, axis n = p/|p| and half-angle
fov/2:

    s = dot(P - p, n) >= cos(fov/2) * |P - p|,

tested for every (pixel, drop) pair; the solid-angle-weighted feature
sums under that mask give each drop's chromaticity and luminance. The
envmap features can be block-reduced (``downsample``): solid-angle
weights are summed per block, the inside test runs at block centers.

On CUDA tensors :func:`cone_sums` launches the hand-written kernel in
``raintpu_torch/csrc/cone_sums.cu`` (each test in registers, the drop's
four sums accumulated there, nothing of size Q x N in memory; the
texel axis split across blocks by :func:`cone_plan` where the drops are
few). On CPU tensors it runs the plain version, :func:`_cone_sums`
(the mask materialised and multiplied with the features), in chunks of
the drop axis for large problems.

Frames may carry a leading batch dimension throughout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from raintpu_torch.ops import color as color_ops
from raintpu_torch.ops.solid_angle import pixel_directions, solid_angle_map


@dataclasses.dataclass
class EnvFeatures:
    """Per-frame envmap reduction features.

    feats: (..., Q, 4) columns = [x*sa, y*sa, Y*sa, sa] per (block of)
    pixel(s); dirs: (Q, 3) unit direction of each block center (the
    same for every frame); total_sa: scalar sum of solid angles over
    the full map; ambient_lum: (...,) sum(Y*sa)/sum(sa).
    """

    feats: torch.Tensor
    dirs: torch.Tensor
    total_sa: torch.Tensor
    ambient_lum: torch.Tensor


def env_features(env_map_rgb: torch.Tensor,
                 downsample: int = 4) -> EnvFeatures:
    """Reduction features of an RGB envmap (..., H, W, 3)."""
    h, w = env_map_rgb.shape[-3], env_map_rgb.shape[-2]
    lead = env_map_rgb.shape[:-3]
    dev, dt = env_map_rgb.device, env_map_rgb.dtype
    xyY = color_ops.rgb_to_xyY(env_map_rgb)
    sa = solid_angle_map(h, w, device=dev, dtype=dt)
    dirs = pixel_directions(h, w, device=dev, dtype=dt)

    total_sa = sa.sum()
    ambient = (xyY[..., 2] * sa).sum(dim=(-2, -1)) / total_sa

    feats = torch.cat([xyY * sa[..., None],
                       sa[..., None].expand(lead + (h, w, 1))], dim=-1)
    if downsample > 1:
        ds = downsample
        hq, wq = (h // ds) * ds, (w // ds) * ds
        # Sum features over blocks (preserves integrals); average dirs.
        f = feats[..., :hq, :wq, :].reshape(lead + (hq // ds, ds,
                                                    wq // ds, ds, 4))
        feats = f.sum(dim=(-4, -2))
        d = dirs[:hq, :wq].reshape(hq // ds, ds, wq // ds, ds, 3)
        d = d.mean(dim=(1, 3))
        dirs = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return EnvFeatures(feats=feats.reshape(lead + (-1, 4)),
                       dirs=dirs.reshape(-1, 3), total_sa=total_sa,
                       ambient_lum=ambient)


def swap_yz(p: torch.Tensor) -> torch.Tensor:
    """Axis swap applied by the reference before FOV math:
    (x, y, z) -> (x, z, y)."""
    return torch.stack([p[..., 0], p[..., 2], p[..., 1]], dim=-1)


# The plain version's largest (frames x Q pixels x N drops) cone mask
# built at once; larger problems are chunked over the drop axis. Each
# chunk holds ~6 float32 (or bool) planes of this size, so 64 M elements
# stay under ~1.5 GB.
MAX_MASK_ELEMS = 64_000_000
_FOV_CHUNK = 256

# The kernel's tiling (csrc/cone_sums.cu): a block owns DROPS_PER_BLOCK
# drops of one frame and walks its part of the texel axis CONE_TILE
# texel blocks (one shared-memory tile) at a time; a launch aims at
# BLOCKS_PER_SM blocks an SM.
DROPS_PER_BLOCK = 512
CONE_TILE = 256
BLOCKS_PER_SM = 16
# The kernel's grid takes at most this many frames and texel parts.
MAX_GRID_YZ = 65535


def _cone_sums(p: torch.Tensor, n: torch.Tensor, env: EnvFeatures,
               cos_t, R) -> torch.Tensor:
    """Per-drop masked feature sums [x*sa, y*sa, Y*sa, sa] (..., N, 4):
    the plain version of :func:`cone_sums`.

    p, n: (..., N, 3). The (Q, N) inside mask is 0/1, so the masked sum
    is a matmul of the mask with the features (exact products in
    float32 with TF32 off)."""
    # s[q, i]  = dot(R*d_q - p_i, n_i) = R * (D . n_i) - p_i . n_i
    # w2[q, i] = |R*d_q - p_i|^2 = R^2 - 2R*(D . p_i) + |p_i|^2
    d0, d1, d2 = (env.dirs[:, k][:, None] for k in range(3))   # (Q, 1)
    nT = n[..., None, :, :]                                    # (..., 1, N, 3)
    pT = p[..., None, :, :]
    Dn = d0 * nT[..., 0] + d1 * nT[..., 1] + d2 * nT[..., 2]   # (..., Q, N)
    Dp = d0 * pT[..., 0] + d1 * pT[..., 1] + d2 * pT[..., 2]
    s = R * Dn - (p * n).sum(-1)[..., None, :]
    w2 = R * R - 2.0 * R * Dp + (p * p).sum(-1)[..., None, :]
    inside = (s >= 0) & (s * s >= (cos_t * cos_t) * w2)
    return torch.matmul(inside.to(env.feats.dtype).transpose(-1, -2),
                        env.feats)


def _plain_cone_sums(p: torch.Tensor, n: torch.Tensor, env: EnvFeatures,
                     cos_t, R) -> torch.Tensor:
    """:func:`_cone_sums`, in chunks of ``_FOV_CHUNK`` drops where the
    mask would pass ``MAX_MASK_ELEMS`` elements."""
    n_drops = p.shape[-2]
    frames = math.prod(p.shape[:-2])
    q = env.dirs.shape[0]
    if frames * q * n_drops <= MAX_MASK_ELEMS or n_drops <= _FOV_CHUNK:
        return _cone_sums(p, n, env, cos_t, R)
    return torch.cat([
        _cone_sums(p[..., i:i + _FOV_CHUNK, :],
                   n[..., i:i + _FOV_CHUNK, :], env, cos_t, R)
        for i in range(0, n_drops, _FOV_CHUNK)], dim=-2)


@dataclasses.dataclass(frozen=True)
class ConePlan:
    """The kernel's grid: ``drop_blocks`` blocks along a frame's drops,
    the texel axis in ``splits`` parts of ``q_per_split`` texel blocks
    (the last part may be shorter), added in order after."""

    drop_blocks: int
    splits: int
    q_per_split: int


def cone_plan(frames: int, n_drops: int, q: int, sms: int) -> ConePlan:
    """Launch plan for ``frames`` x ``n_drops`` drops over ``q`` texel
    blocks on a card of ``sms`` SMs: the texel axis split into as few
    parts as make BLOCKS_PER_SM blocks an SM, and into no more parts
    than it has tiles of CONE_TILE texel blocks."""
    drop_blocks = -(-n_drops // DROPS_PER_BLOCK)
    want = -(-BLOCKS_PER_SM * sms // (frames * drop_blocks))
    splits = max(1, min(want, -(-q // CONE_TILE), MAX_GRID_YZ))
    q_per_split = -(-q // splits)
    return ConePlan(drop_blocks, -(-q // q_per_split), q_per_split)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_fn():
    from raintpu_torch import cuda_build

    lib = cuda_build.load("cone_sums")
    fn = lib.cone_sums_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.cone_sums_error_string.argtypes = [ctypes.c_int]
        lib.cone_sums_error_string.restype = ctypes.c_char_p
    return lib, fn


def _broadcast(a, b) -> tuple:
    """The broadcast of two shapes; a mismatch raises where a tensor is
    expanded to it. (torch.broadcast_shapes imports torch.fx's symbolic
    shapes, and with them sympy: seconds at its first call.)"""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _kernel_cone_sums(p: torch.Tensor, n: torch.Tensor, env: EnvFeatures,
                      cos_t: torch.Tensor, R: float) -> torch.Tensor:
    """:func:`_cone_sums` by the CUDA kernel: one launch (two where the
    texel axis is split), on the current stream, no synchronisation.
    pn, pp and cos_t^2 are the plain version's expressions, so the
    kernel's inside mask is the plain version's."""
    tensors = (p, n, env.dirs, env.feats, cos_t)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("cone_sums: the kernel takes float32 tensors")
    if any(t.device != p.device for t in tensors):
        raise ValueError("cone_sums: tensors on more than one device")
    lead = _broadcast(p.shape[:-2], env.feats.shape[:-2])
    frames, n_drops, q = math.prod(lead), p.shape[-2], env.dirs.shape[0]
    if frames > MAX_GRID_YZ:
        raise ValueError(f"cone_sums: {frames} frames, the kernel takes "
                         f"at most {MAX_GRID_YZ}")
    if frames == 0 or n_drops == 0 or q == 0:
        return torch.zeros(lead + (n_drops, 4), dtype=torch.float32,
                           device=p.device)
    pn = (p * n).sum(-1)
    pp = (p * p).sum(-1)
    c2 = cos_t * cos_t

    def rows(t, width):
        return t.expand(lead + t.shape[-2:]).reshape(
            frames, n_drops, width).contiguous()

    p3, n3 = rows(p, 3), rows(n, 3)
    pn, pp = rows(pn[..., None], 1), rows(pp[..., None], 1)
    dirs = env.dirs.contiguous()
    feats = env.feats.expand(lead + env.feats.shape[-2:]).reshape(
        frames, q, 4).contiguous()
    plan = cone_plan(frames, n_drops, q, _sm_count(p.device))
    out = torch.empty((frames, n_drops, 4), dtype=torch.float32,
                      device=p.device)
    partial = (torch.empty((plan.splits, frames, n_drops, 4),
                           dtype=torch.float32, device=p.device)
               if plan.splits > 1 else None)
    lib, fn = _kernel_fn()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p3.data_ptr(), n3.data_ptr(), pn.data_ptr(), pp.data_ptr(),
                 dirs.data_ptr(), feats.data_ptr(), c2.data_ptr(), float(R),
                 float(R * R), float(2.0 * R),
                 None if partial is None else partial.data_ptr(),
                 out.data_ptr(), frames, n_drops, q, plan.drop_blocks,
                 plan.splits, plan.q_per_split, stream)
    if err != 0:
        raise RuntimeError("cone_sums kernel launch failed: "
                           + lib.cone_sums_error_string(err).decode())
    cone_sums.launches += 1
    return out.reshape(lead + (n_drops, 4))


def cone_sums(p: torch.Tensor, n: torch.Tensor, env: EnvFeatures,
              cos_t: torch.Tensor, R: float) -> torch.Tensor:
    """Per-drop masked feature sums [x*sa, y*sa, Y*sa, sa] (..., N, 4)
    of the cones with apexes ``p`` and axes ``n`` (..., N, 3): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``cone_sums.launches`` counts kernel launches."""
    if p.device.type == "cpu":
        return _plain_cone_sums(p, n, env, cos_t, R)
    if p.device.type != "cuda":
        raise ValueError(f"cone_sums: no kernel for {p.device.type}")
    return _kernel_cone_sums(p, n, env, cos_t, R)


cone_sums.launches = 0


@functools.lru_cache(maxsize=None)
def _cos_half_angle(fov_deg: float, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """cos(fov/2) of the cone, computed on ``device`` in ``dtype`` once
    per (fov, dtype, device) (see ``color.device_constant``)."""
    return torch.cos(torch.deg2rad(
        color_ops.device_constant(fov_deg / 2.0, dtype, device)))


def drop_fov_stats(world_pos: torch.Tensor,
                   env: EnvFeatures,
                   *,
                   sphere_radius: float = 10.0,
                   fov_deg: float = 165.0) -> Tuple[torch.Tensor, ...]:
    """Masked envmap reductions for a batch of drops.

    world_pos: (..., N, 3) mid-streak world positions in the parsed
    frame (z already negated); the FOV axis swap is applied here.

    Returns (fov_xy_avg (..., N, 2), avg_fov_lum (..., N),
    in_fov_frac (..., N)): the solid-angle-weighted mean chromaticity
    inside the cone, and the in-cone luminance and solid angle over the
    FULL map's solid angle.
    """
    p = swap_yz(world_pos)
    norm = torch.sqrt((p * p).sum(-1, keepdim=True))
    n = p / torch.clamp_min(norm, 1e-12)           # cone axis per drop

    cos_t = _cos_half_angle(float(fov_deg), p.dtype, p.device)
    sums = cone_sums(p, n, env, cos_t, float(sphere_radius))

    # Degenerate drops (zero world position, or a cone that misses the
    # map) have no coverage: neutral chromaticity + zero luminance
    # renders them invisibly.
    covered = sums[..., 3] > 1e-9
    sa_in = torch.where(covered, sums[..., 3], torch.ones_like(sums[..., 3]))
    fov_xy_avg = torch.where(covered[..., None],
                             sums[..., :2] / sa_in[..., None], 1.0 / 3.0)
    avg_fov_lum = torch.where(covered, sums[..., 2] / env.total_sa, 0.0)
    return fov_xy_avg, avg_fov_lum, sums[..., 3] / env.total_sa


def drop_colors(world_pos: torch.Tensor,
                env: EnvFeatures,
                *,
                sphere_radius: float = 10.0,
                fov_deg: float = 165.0,
                irrad_type: str = "ambient") -> torch.Tensor:
    """Uniform per-drop RGB gain vectors (..., N, 3): a drop's patch
    color is ``gray(px) * gain`` with drop luminance
    0.94*avg_fov_lum + 0.06*ambient_lum ('ambient') or 1 ('garg')."""
    fov_xy, fov_lum, _ = drop_fov_stats(
        world_pos, env, sphere_radius=sphere_radius, fov_deg=fov_deg)
    # Guard y ~ 0 (an all-black cone region averages to xy = (0, 0)):
    # the basis divides by y; fall back to the neutral point.
    bad = fov_xy[..., 1] < 1e-6
    fx = torch.where(bad, 1.0 / 3.0, fov_xy[..., 0])
    fy = torch.where(bad, 1.0 / 3.0, fov_xy[..., 1])
    base = color_ops.xyY_basis_rgb(fx, fy)                     # (..., N, 3)
    if irrad_type == "ambient":
        drop_Y = 0.94 * fov_lum + 0.06 * env.ambient_lum[..., None]
    else:  # 'garg' — the reference leaves luminance unscaled
        drop_Y = torch.ones_like(fov_lum)
    return base * (color_ops.GRAY_TO_Y * drop_Y)[..., None]
