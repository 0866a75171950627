"""Fused streak raster+composite: the kernel of the render path.

Per (frame b, slot c) of a rung, over the rung's (ph, pw) window at the
drop's anchor, every pixel

  1. maps through the drop's inverse homography to normalized texture
     coords (x̂, ŷ);
  2. evaluates the rank-R damped DCT series
     g = Σ_r (Σ_m ayc[r,m] cos(mπŷ)) (Σ_n bxc[r,n] cos(nπx̂))
     by Chebyshev recurrence, clips it to [0, 1], multiplies it by the
     tanh-erf content window (hard cut at 4σ + 0.25) and zeroes it
     below ALPHA_CUTOFF;
  3. adds g, log(max(1 - g·lo, LOG_EPS)) and g·add_rgb — and, with the
     saturation planes, clip(g·sat_rgb, 0, 1) — into the frame's five
     (or eight) image-sized float32 planes (alpha, log_att, add_r,
     add_g, add_b[, sat_r, sat_g, sat_b]).

Slots at or beyond ``n_valid[b]`` are skipped, and window pixels
outside the image are dropped (the JAX package pads its planes and
crops them afterwards, which gives the same cropped sums).

This replaces the Pallas kernels of ``raintpu/ops/pallas/fused_kernel.py``
on the render path: ``_make_kernel_pipelined`` (single-tile windows,
one call per rung), ``_make_kernel`` (the same call for windows over
MAX_SLAB_AREA, evaluated in row tiles) and ``_make_kernel_resident``
(all rungs in one call, the stack in VMEM). All three compute these
sums; they differ only in TPU memory placement, so one CUDA kernel
takes windows of any size. :func:`fused_raster_composite` runs the
hand-written CUDA kernel (``raintpu_torch/csrc/fused_raster.cu``) on
CUDA tensors and :func:`fused_raster_plain`, the same math in plain
PyTorch following ``_patch_eval``/``_plane_contribs`` line for line, on
CPU tensors. :func:`raster_plan` cuts each window into row chunks of
about ``TARGET_PX`` pixels, one kernel block each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence, Tuple

import torch

# Params row layout (N_PARAMS, C) per frame, as fused_kernel.py's P_*.
# P_SGX/P_SGY: blur sigma in normalized texture coordinates.
P_M00, P_M01, P_M02, P_M10, P_M11, P_M12, P_M20, P_M21, P_M22 = range(9)
P_MINCX, P_MINCY, P_WCX, P_WCY, P_SGX, P_SGY, P_LO = range(9, 16)
P_ADDR, P_ADDG, P_ADDB = range(16, 19)
# Pre-tau drop color, read only with the saturation planes.
P_SATR, P_SATG, P_SATB = range(19, 22)
# Content band (UL, UU, VL, VU) in normalized texture coords.
P_UL, P_UU, P_VL, P_VU = range(22, 26)
N_PARAMS = 26

LOG_EPS = 1e-6
ALPHA_CUTOFF = 2e-4
N_PLANES = 5    # alpha, log_att, add_r, add_g, add_b
N_PLANES_SAT = 8  # ... and sat_r, sat_g, sat_b (the saturation mask)
# The plain version evaluates at most this many window pixels at once:
# _patch_eval keeps ~15 tensors of that size alive.
PLAIN_CHUNK_PX = 1 << 24
# The kernel gives each block a chunk of whole window rows holding about
# this many pixels (8 a thread): a big window spreads over many SMs.
TARGET_PX = 2048
# CUDA's grid limits: x up to 2**31 - 1, y (the frames) up to 65535.
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


@dataclasses.dataclass
class RasterRung:
    """One rung's kernel operands for a batch of B frames."""

    params: torch.Tensor    # (B, N_PARAMS, C) float32
    anchor: torch.Tensor    # (B, C, 2) int32 image (x, y) of the window origin
    ayc: torch.Tensor       # (B, C, R, My) float32
    bxc: torch.Tensor       # (B, C, R, Mx) float32
    n_valid: torch.Tensor   # (B,) int32 — slots [0, n_valid) hold drops
    patch_hw: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """The kernel's launch plan for one rung: each window splits into
    ``n_chunks`` chunks of ``rows`` rows (the last may be shorter), one
    block per (slot, chunk) on grid x, chunk fastest, and per frame on
    grid y."""

    rows: int
    n_chunks: int
    grid: Tuple[int, int]


def raster_plan(patch_hw, slots: int, frames: int) -> RasterPlan:
    """Launch plan of a rung of ``slots`` slots over ``frames`` frames,
    from shapes alone (the kernel's blocks skip empty slots and chunks
    below the image themselves)."""
    ph, pw = patch_hw
    rows = min(ph, max(1, TARGET_PX // pw))
    n_chunks = -(-ph // rows)
    grid = (slots * n_chunks, frames)
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y:
        raise ValueError(f"fused_raster: grid {grid} exceeds CUDA's limits "
                         f"({MAX_GRID_X}, {MAX_GRID_Y})")
    return RasterPlan(rows, n_chunks, grid)


def _erf(x):
    # The model's tanh approximation of erf (fused_kernel._erf).
    x3 = x * x * x
    return torch.tanh(1.1283791671 * x + 0.1009055155 * x3)


def _patch_eval(rung: RasterRung, th: int, tw: int) -> torch.Tensor:
    """Gray patch g over every slot's window, (B, C, ph, pw)."""
    ph, pw = rung.patch_hw
    dev = rung.params.device
    prm_all = rung.params[..., None, None]              # (B, 26, C, 1, 1)

    def prm(k):
        return prm_all[:, k]

    def cy(r, m):
        return rung.ayc[:, :, r, m, None, None]

    def cx(r, m):
        return rung.bxc[:, :, r, m, None, None]

    ii = torch.arange(ph, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
    ax = rung.anchor[..., 0].to(torch.float32)[..., None, None]
    ay = rung.anchor[..., 1].to(torch.float32)[..., None, None]
    lx = jj + (ax - prm(P_MINCX))
    ly = ii + (ay - prm(P_MINCY))

    hx = prm(P_M00) * lx + prm(P_M01) * ly + prm(P_M02)
    hy = prm(P_M10) * lx + prm(P_M11) * ly + prm(P_M12)
    hz = prm(P_M20) * lx + prm(P_M21) * ly + prm(P_M22)
    hz = torch.where(torch.abs(hz) < 1e-9, 1e-9, hz)
    inv_hz = 1.0 / hz
    xhat = (hx * inv_hz + 0.5) * (1.0 / tw)
    yhat = (hy * inv_hz + 0.5) * (1.0 / th)

    # Damped DCT series via Chebyshev recurrence, rank by rank.
    r_ranks, modes_y, modes_x = (rung.ayc.shape[2], rung.ayc.shape[3],
                                 rung.bxc.shape[3])
    ty = torch.cos(math.pi * yhat)
    tx = torch.cos(math.pi * xhat)
    g = torch.zeros_like(xhat)
    zero = torch.zeros_like(xhat)
    for r in range(r_ranks):
        uy = zero + cy(r, 0)
        cm_prev = torch.ones_like(ty)
        cm = ty
        for m in range(1, modes_y):
            uy = uy + cy(r, m) * cm
            cm, cm_prev = 2.0 * ty * cm - cm_prev, cm
        vx = zero + cx(r, 0)
        cm_prev = torch.ones_like(tx)
        cm = tx
        for m in range(1, modes_x):
            vx = vx + cx(r, m) * cm
            cm, cm_prev = 2.0 * tx * cm - cm_prev, cm
        g = g + uy * vx

    # erf content window: blurred indicator of the texture rect in
    # normalized texture coordinates, hard-cut at 4 sigma + 0.25.
    sqrt2 = 1.4142135
    sx = torch.clamp_min(prm(P_SGX), 2e-3)
    sy = torch.clamp_min(prm(P_SGY), 2e-3)
    ul, uu = prm(P_UL), prm(P_UU)
    vl, vu = prm(P_VL), prm(P_VU)
    win = (0.5 * (_erf((xhat - ul) / (sqrt2 * sx))
                  - _erf((xhat - uu) / (sqrt2 * sx)))
           * 0.5 * (_erf((yhat - vl) / (sqrt2 * sy))
                    - _erf((yhat - vu) / (sqrt2 * sy))))
    mx = 0.25 + 4.0 * sx
    my = 0.25 + 4.0 * sy
    win = torch.where((xhat >= ul - mx) & (xhat <= uu + mx)
                      & (yhat >= vl - my) & (yhat <= vu + my), win, 0.0)
    g = torch.clamp(g, 0.0, 1.0) * win
    return torch.where(g > ALPHA_CUTOFF, g, 0.0)


def _check_rung(rung: RasterRung, bsz: int, device) -> None:
    b, n_params, c = rung.params.shape
    r = rung.ayc.shape[2]
    checks = [
        (rung.params.dtype == torch.float32, "params must be float32"),
        (n_params == N_PARAMS, f"params need {N_PARAMS} rows"),
        (b == bsz, "rungs disagree on the batch size"),
        (rung.anchor.dtype == torch.int32
         and tuple(rung.anchor.shape) == (b, c, 2),
         "anchor must be int32 (B, C, 2)"),
        (rung.ayc.dtype == torch.float32 and rung.ayc.ndim == 4
         and tuple(rung.ayc.shape[:2]) == (b, c),
         "ayc must be float32 (B, C, R, My)"),
        (rung.bxc.dtype == torch.float32 and rung.bxc.ndim == 4
         and tuple(rung.bxc.shape[:3]) == (b, c, r),
         "bxc must be float32 (B, C, R, Mx)"),
        (rung.n_valid.dtype == torch.int32
         and tuple(rung.n_valid.shape) == (b,),
         "n_valid must be int32 (B,)"),
        (all(t.device == device for t in (rung.params, rung.anchor,
                                           rung.ayc, rung.bxc,
                                           rung.n_valid)),
         "all operands must be on one device"),
        (all(t.is_contiguous() for t in (rung.params, rung.anchor,
                                         rung.ayc, rung.bxc,
                                         rung.n_valid)),
         "operands must be contiguous"),
        (min(rung.patch_hw) > 0, "patch_hw must be positive"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"fused_raster: {msg}")


def _sub_rung(rung: RasterRung, b0: int, b1: int, c0: int,
              c1: int) -> RasterRung:
    """Frames [b0, b1) and slots [c0, c1) of a rung."""
    return RasterRung(
        params=rung.params[b0:b1, :, c0:c1],
        anchor=rung.anchor[b0:b1, c0:c1], ayc=rung.ayc[b0:b1, c0:c1],
        bxc=rung.bxc[b0:b1, c0:c1],
        n_valid=torch.clamp(rung.n_valid[b0:b1] - c0, 0, c1 - c0),
        patch_hw=rung.patch_hw)


def _accumulate_plain(planes: torch.Tensor, rung: RasterRung, tex_hw,
                      chunk_px: int) -> None:
    """planes (B, P, H, W) += this rung's contributions, evaluated over
    chunks of at most ``chunk_px`` window pixels (whole frames when a
    frame's slots fit, else slot ranges of one frame). Slots past the
    batch's largest n_valid are not evaluated."""
    bsz = planes.shape[0]
    ph, pw = rung.patch_hw
    c = min(rung.params.shape[2], int(rung.n_valid.max()))
    if c <= 0:
        return
    frame_px = c * ph * pw
    if frame_px <= chunk_px:
        step = max(1, chunk_px // frame_px)
        for b0 in range(0, bsz, step):
            b1 = min(b0 + step, bsz)
            _accumulate_chunk(planes[b0:b1], _sub_rung(rung, b0, b1, 0, c),
                              tex_hw)
        return
    step = max(1, chunk_px // (ph * pw))
    for b in range(bsz):
        for c0 in range(0, c, step):
            _accumulate_chunk(
                planes[b:b + 1],
                _sub_rung(rung, b, b + 1, c0, min(c0 + step, c)), tex_hw)


def _accumulate_chunk(planes: torch.Tensor, rung: RasterRung,
                      tex_hw) -> None:
    """planes (B, P, H, W) += one chunk's contributions (every slot of
    the chunk evaluated at once)."""
    bsz, n_planes, h, w = planes.shape
    ph, pw = rung.patch_hw
    dev = planes.device
    c = rung.params.shape[2]
    g = _patch_eval(rung, tex_hw[0], tex_hw[1])          # (B, C, ph, pw)

    ys = rung.anchor[..., 1].to(torch.int64)[..., None, None] + \
        torch.arange(ph, device=dev)[:, None]
    xs = rung.anchor[..., 0].to(torch.int64)[..., None, None] + \
        torch.arange(pw, device=dev)[None, :]
    slot_ok = (torch.arange(c, device=dev)[None, :]
               < rung.n_valid.to(torch.int64)[:, None])[..., None, None]
    sel = slot_ok & (ys < h) & (xs < w) & (g != 0)
    frame = torch.arange(bsz, device=dev)[:, None, None, None]
    idx = (frame * (n_planes * h * w) + ys * w + xs).expand(g.shape)[sel]

    def per_pixel(k):
        return rung.params[:, k, :, None, None].expand(g.shape)[sel]

    gs = g[sel]
    contribs = [gs,
                torch.log(torch.clamp_min(1.0 - gs * per_pixel(P_LO),
                                          LOG_EPS)),
                gs * per_pixel(P_ADDR), gs * per_pixel(P_ADDG),
                gs * per_pixel(P_ADDB)]
    if n_planes == N_PLANES_SAT:
        # Saturation planes: the sum of clip(drop_rgb, 0, 1) per drop.
        contribs += [torch.clamp(gs * per_pixel(k), 0.0, 1.0)
                     for k in (P_SATR, P_SATG, P_SATB)]
    flat = planes.view(-1)
    for k, v in enumerate(contribs):
        flat.index_put_((idx + k * h * w,), v, accumulate=True)


def _new_planes(rungs, image_hw, n_planes) -> torch.Tensor:
    if n_planes not in (N_PLANES, N_PLANES_SAT):
        raise ValueError(f"fused_raster: n_planes must be {N_PLANES} or "
                         f"{N_PLANES_SAT}, not {n_planes}")
    device = rungs[0].params.device
    bsz = rungs[0].params.shape[0]
    for rung in rungs:
        _check_rung(rung, bsz, device)
    return torch.zeros((bsz, n_planes) + tuple(image_hw),
                       dtype=torch.float32, device=device)


def fused_raster_plain(rungs: Sequence[RasterRung], image_hw, tex_hw,
                       n_planes: int = N_PLANES,
                       chunk_px: int = PLAIN_CHUNK_PX) -> torch.Tensor:
    """Plain PyTorch version: (B, n_planes, H, W) float32 planes."""
    planes = _new_planes(rungs, image_hw, n_planes)
    for rung in rungs:
        _accumulate_plain(planes, rung, tex_hw, chunk_px)
    return planes


def _kernel_fn():
    from raintpu_torch import cuda_build

    lib = cuda_build.load("fused_raster")
    fn = lib.fused_raster_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_raster_error_string.argtypes = [ctypes.c_int]
        lib.fused_raster_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(planes: torch.Tensor, rung: RasterRung, tex_hw) -> None:
    bsz, n_planes, h, w = planes.shape
    _, _, c = rung.params.shape
    _, _, r, my = rung.ayc.shape
    mx = rung.bxc.shape[3]
    plan = raster_plan(rung.patch_hw, c, bsz)
    lib, fn = _kernel_fn()
    th, tw = tex_hw
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(rung.params.data_ptr(), rung.anchor.data_ptr(),
                 rung.ayc.data_ptr(), rung.bxc.data_ptr(),
                 rung.n_valid.data_ptr(), planes.data_ptr(),
                 bsz, c, r, my, mx, rung.patch_hw[0], rung.patch_hw[1],
                 h, w, n_planes, 1.0 / th, 1.0 / tw, plan.rows,
                 plan.n_chunks, *plan.grid, stream)
    if err != 0:
        raise RuntimeError("fused_raster kernel launch failed: "
                           + lib.fused_raster_error_string(err).decode())
    fused_raster_composite.launches += 1
    counts = fused_raster_composite.window_launches
    counts[rung.patch_hw] = counts.get(rung.patch_hw, 0) + 1


def fused_raster_composite(rungs: Sequence[RasterRung], image_hw,
                           tex_hw, n_planes: int = N_PLANES) -> torch.Tensor:
    """Accumulate every rung's drops into fresh (B, n_planes, H, W)
    float32 planes (n_planes 5, or 8 with the saturation planes): the
    CUDA kernel (one launch per rung, cut by :func:`raster_plan`, on the
    current stream, no synchronisation) for CUDA tensors, the plain version for CPU
    tensors. ``fused_raster_composite.launches`` counts kernel
    launches, and ``fused_raster_composite.window_launches`` counts them
    by the rung's (ph, pw) window."""
    device = rungs[0].params.device
    if device.type == "cpu":
        return fused_raster_plain(rungs, image_hw, tex_hw, n_planes)
    if device.type != "cuda":
        raise ValueError(f"fused_raster: no kernel for {device.type}")
    planes = _new_planes(rungs, image_hw, n_planes)
    for rung in rungs:
        _launch(planes, rung, tex_hw)
    return planes


fused_raster_composite.launches = 0
fused_raster_composite.window_launches = {}
