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
     (or eight) image-sized planes (alpha, log_att, add_r, add_g,
     add_b[, sat_r, sat_g, sat_b]).

Slots at or beyond ``n_valid[b]`` are skipped, and window pixels
outside the image are dropped (the JAX package pads its planes and
crops them afterwards, which gives the same cropped sums).

Each pixel's sums run rung-major, slot-minor: rung after rung, and
within a rung slot after slot.

The planes are float32, or bfloat16 as the JAX package's
``PipelineConfig.fields_dtype="bfloat16"`` makes them. In bfloat16 each
drop's contribution is rounded into the planes as the JAX kernels round
it (``_accum_rows`` and ``_accum_rows_strip``), pixel by pixel in the
same order: acc = bf16(acc + c) on a rung that the JAX package
evaluates on full windows or in row tiles, and acc = bf16(acc + bf16(c))
on a strip rung (``bucket_strip_pad(ph, pw, radius, 16) > 0``), whose
contribution the JAX kernel casts to bfloat16 before it adds it. The
rung's ``round_first`` flag says which rule it takes.

This replaces the Pallas kernels of ``raintpu/ops/pallas/fused_kernel.py``
on the render path: ``_make_kernel_pipelined`` (single-tile windows,
one call per rung), ``_make_kernel`` (the same call for windows over
MAX_SLAB_AREA, evaluated in row tiles) and ``_make_kernel_resident``
(all rungs in one call, the frame's plane stack held on chip and
written once). All three compute these sums. :func:`fused_raster_composite`
runs the hand-written CUDA kernel (``raintpu_torch/csrc/fused_raster.cu``)
on CUDA tensors and :func:`fused_raster_plain`, the same math in plain
PyTorch following ``_patch_eval``/``_plane_contribs`` line for line, on
CPU tensors.

The kernel follows the resident scheme: one launch takes every rung of
the call (a table of at most ``MAX_RUNGS`` records), one block per
(image tile, frame). A block lists the drops whose windows overlap its
tile, in rung-major, slot-minor order, sums their contributions in
shared memory in that order, and writes the tile's planes once: no
zero-fill, no global atomics, and two launches give bit-identical
planes. :func:`tile_plan` picks the tile, the grid and the shared
memory from shapes alone; the host never reads ``n_valid``.
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
# The kernel's image tile (rows, columns): one block per tile and frame,
# its planes summed in shared memory. Of the tiles swept on the card,
# (32, 64) timed best on the bench rungs, ~2% ahead of (16, 128);
# on the CLI's rungs the two trade places from run to run (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md section 6).
TILE_HW = (32, 64)
# Constants of the kernel's layout (csrc/fused_raster.cu): threads a
# block, rungs a launch, ranks of a rung's series, entries of the block's drop list, drops staged
# a round (one a warp), ints of a staged drop's header, and the shared
# memory a block may use on an H100.
THREADS = 256
MAX_RUNGS = 8
MAX_RANKS = 8
LIST_CAP = 512
STAGE = THREADS // 32
DROP_HDR = 9
MAX_SMEM_BYTES = 232448
# CUDA's grid limits: x up to 2**31 - 1, y (the frames) up to 65535.
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535
# The kernel's compile-time knockouts (csrc/fused_raster.cu,
# RAINTPU_ABLATE), for tools/kernel_ablation: the bit of each component
# a variant leaves out. The render path never sets one.
ABLATE_BITS = {"noeval": 1, "noplace": 2, "noaccum": 4, "nowrite": 8,
               "nostage": 16}
# The JAX kernels' window tiling (fused_kernel.py): lanes, the float32
# planes' sublanes (16 for bfloat16 planes) and the window area above
# which a window is evaluated in row tiles. Here they only decide which
# rungs round a bfloat16 contribution first (bucket_strip_pad) and which
# of the JAX package's kernel bodies a rung's window takes (plan_window).
LANE = 128
SUBLANE = 8
SUBLANE_BF16 = 16
MAX_SLAB_AREA = 80_000
PLANE_DTYPES = (torch.float32, torch.bfloat16)


def plan_window(ph: int, pw: int, sublane: int = SUBLANE):
    """The JAX package's tile-aligned window plan of a rung (a copy of
    ``fused_kernel.plan_window``): (ph2, pw2, tile_h, n_tiles). More
    than one row tile is the multi-tile body (K2)."""
    ph2 = -(-(ph + sublane) // sublane) * sublane
    pw2 = -(-(pw + LANE) // LANE) * LANE
    n_tiles = max(1, -(-(ph2 * pw2) // MAX_SLAB_AREA))
    tile_h = -(-(-(-ph2 // n_tiles)) // sublane) * sublane
    ph2 = n_tiles * tile_h
    return ph2, pw2, tile_h, n_tiles


def bucket_strip_pad(ph: int, pw: int, radius: int,
                     sublane: int = SUBLANE) -> int:
    """The JAX package's strip pad of a rung, or 0 when the rung is not
    evaluated on a strip (a copy of ``fused_kernel.bucket_strip_pad``):
    content and erf tails must fit one LANE-wide strip and the window
    one row tile."""
    pad = int(1.25 * radius) + 2
    if pw + 2 * pad > LANE:
        return 0
    if plan_window(ph, pw, sublane)[3] != 1:
        return 0
    return pad


@dataclasses.dataclass
class RasterRung:
    """One rung's kernel operands for a batch of B frames."""

    params: torch.Tensor    # (B, N_PARAMS, C) float32
    anchor: torch.Tensor    # (B, C, 2) int32 image (x, y) of the window origin
    ayc: torch.Tensor       # (B, C, R, My) float32
    bxc: torch.Tensor       # (B, C, R, Mx) float32
    n_valid: torch.Tensor   # (B,) int32 — slots [0, n_valid) hold drops
    patch_hw: Tuple[int, int]
    # bfloat16 planes only: round each contribution to bfloat16 before
    # adding it (the JAX package's strip rungs), else round once after.
    round_first: bool = False


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernel's launch plan for one call: tiles of ``tile_hw``
    pixels cover the image, one block per (tile, frame) on the grid
    (tiles, frames), tiles row-major; each block takes ``smem_bytes`` of
    shared memory for its planes, a drop list of ``list_cap`` entries and
    staged drops of up to ``coef_floats`` series coefficients."""

    tile_hw: Tuple[int, int]
    grid: Tuple[int, int]
    smem_bytes: int
    list_cap: int
    n_rungs: int
    coef_floats: int


def raster_smem_bytes(n_planes: int, tile_hw, coef_floats: int) -> int:
    """Shared memory of one block (the kernel's layout): the tile's
    planes, the drop list, the warps' hit counts, the rungs' offsets in
    the scan, and STAGE staged drops (header, params, coefficients)."""
    floats = (n_planes * tile_hw[0] * tile_hw[1] + LIST_CAP + THREADS // 32
              + MAX_RUNGS + 1 + STAGE * DROP_HDR
              + STAGE * (N_PARAMS + coef_floats))
    return 4 * floats


def tile_plan(image_hw, series: Sequence[Tuple[int, int, int]],
              frames: int, n_planes: int) -> TilePlan:
    """Launch plan of one call over rungs whose series shapes are
    ``series`` ((R, My, Mx) each, in rung order), from shapes alone."""
    h, w = image_hw
    if not 1 <= len(series) <= MAX_RUNGS:
        raise ValueError(f"fused_raster: one launch takes 1 to {MAX_RUNGS} "
                         f"rungs, not {len(series)}")
    th, tw = TILE_HW
    grid = (-(-h // th) * -(-w // tw), frames)
    if not (0 < grid[0] <= MAX_GRID_X and 0 < grid[1] <= MAX_GRID_Y):
        raise ValueError(f"fused_raster: grid {grid} exceeds CUDA's limits "
                         f"({MAX_GRID_X}, {MAX_GRID_Y})")
    if max(r for r, _, _ in series) > MAX_RANKS:
        raise ValueError(f"fused_raster: the kernel takes series of at most "
                         f"{MAX_RANKS} ranks")
    coef = max(r * (my + mx) for r, my, mx in series)
    smem = raster_smem_bytes(n_planes, TILE_HW, coef)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_raster: a block needs {smem} B of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")
    return TilePlan(TILE_HW, grid, smem, LIST_CAP, len(series), coef)


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
    return dataclasses.replace(
        rung, params=rung.params[b0:b1, :, c0:c1],
        anchor=rung.anchor[b0:b1, c0:c1], ayc=rung.ayc[b0:b1, c0:c1],
        bxc=rung.bxc[b0:b1, c0:c1],
        n_valid=torch.clamp(rung.n_valid[b0:b1] - c0, 0, c1 - c0))


def _accumulate_plain(planes: torch.Tensor, rung: RasterRung, tex_hw,
                      chunk_px: int, bf16: bool) -> None:
    """planes (B, P, H, W) += this rung's contributions, evaluated over
    chunks of at most ``chunk_px`` window pixels (whole frames when a
    frame's slots fit, else slot ranges of one frame). Slots past the
    batch's largest n_valid are not evaluated. ``bf16``: the planes hold
    bfloat16 values (in float32), and each contribution is rounded into
    them by the rung's rule, slot after slot."""
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
                              tex_hw, bf16)
        return
    step = max(1, chunk_px // (ph * pw))
    for b in range(bsz):
        for c0 in range(0, c, step):
            _accumulate_chunk(
                planes[b:b + 1],
                _sub_rung(rung, b, b + 1, c0, min(c0 + step, c)), tex_hw,
                bf16)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), kept float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _contribs(params: torch.Tensor, g: torch.Tensor, sel: torch.Tensor,
              n_planes: int) -> list:
    """Each plane's contributions at the selected pixels of patches g
    (B, C, ph, pw) of drops with ``params`` (B, N_PARAMS, C)."""
    def per_pixel(k):
        return params[:, k, :, None, None].expand(g.shape)[sel]

    gs = g[sel]
    out = [gs,
           torch.log(torch.clamp_min(1.0 - gs * per_pixel(P_LO), LOG_EPS)),
           gs * per_pixel(P_ADDR), gs * per_pixel(P_ADDG),
           gs * per_pixel(P_ADDB)]
    if n_planes == N_PLANES_SAT:
        # Saturation planes: the sum of clip(drop_rgb, 0, 1) per drop.
        out += [torch.clamp(gs * per_pixel(k), 0.0, 1.0)
                for k in (P_SATR, P_SATG, P_SATB)]
    return out


def _accumulate_chunk(planes: torch.Tensor, rung: RasterRung, tex_hw,
                      bf16: bool) -> None:
    """planes (B, P, H, W) += one chunk's contributions (every slot of
    the chunk evaluated at once). In float32 they are summed in one
    scatter-add; with ``bf16`` slot after slot, each rounded into the
    planes (:func:`_to_bf16`), so that every pixel takes its drops in
    slot order as the JAX kernel does."""
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
    idx = (frame * (n_planes * h * w) + ys * w + xs).expand(g.shape)
    flat = planes.view(-1)
    if not bf16:
        pix = idx[sel]
        for k, v in enumerate(_contribs(rung.params, g, sel, n_planes)):
            flat.index_put_((pix + k * h * w,), v, accumulate=True)
        return
    for s in range(c):
        one = slice(s, s + 1)
        pix = idx[:, one][sel[:, one]]
        for k, v in enumerate(_contribs(rung.params[:, :, one], g[:, one],
                                        sel[:, one], n_planes)):
            pos = pix + k * h * w
            if rung.round_first:
                v = _to_bf16(v)
            flat[pos] = _to_bf16(flat[pos] + v)


def _check_rungs(rungs, n_planes) -> None:
    if n_planes not in (N_PLANES, N_PLANES_SAT):
        raise ValueError(f"fused_raster: n_planes must be {N_PLANES} or "
                         f"{N_PLANES_SAT}, not {n_planes}")
    device = rungs[0].params.device
    bsz = rungs[0].params.shape[0]
    for rung in rungs:
        _check_rung(rung, bsz, device)


def _check_dtype(dtype) -> None:
    if dtype not in PLANE_DTYPES:
        raise ValueError(f"fused_raster: planes are float32 or bfloat16, "
                         f"not {dtype}")


def fused_raster_plain(rungs: Sequence[RasterRung], image_hw, tex_hw,
                       n_planes: int = N_PLANES,
                       chunk_px: int = PLAIN_CHUNK_PX,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: (B, n_planes, H, W) planes of ``dtype``
    (float32 or bfloat16)."""
    _check_rungs(rungs, n_planes)
    _check_dtype(dtype)
    bf16 = dtype == torch.bfloat16
    planes = torch.zeros((rungs[0].params.shape[0], n_planes)
                         + tuple(image_hw), dtype=torch.float32,
                         device=rungs[0].params.device)
    for rung in rungs:
        _accumulate_plain(planes, rung, tex_hw, chunk_px, bf16)
    return planes.to(dtype)


class _RungRecord(ctypes.Structure):
    """One rung of the kernel's table (``struct Rung`` in the source)."""

    _fields_ = [("params", ctypes.c_void_p), ("anchor", ctypes.c_void_p),
                ("ayc", ctypes.c_void_p), ("bxc", ctypes.c_void_p),
                ("n_valid", ctypes.c_void_p)] + [
                    (k, ctypes.c_int)
                    for k in ("C", "R", "My", "Mx", "ph", "pw")]


def ablate_bits(ablate: str) -> int:
    """The knockout bits of ``ablate``: names of ABLATE_BITS joined by
    "+" ("" for none). An unknown or repeated name raises ValueError,
    and so does nostage without noeval and noplace (its staging slots
    would feed them garbage)."""
    names = [n for n in ablate.split("+") if n] if ablate else []
    unknown = [n for n in names if n not in ABLATE_BITS]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"fused_raster: ablate {ablate!r}: each name once, "
                         f"of {sorted(ABLATE_BITS)}")
    bits = sum(ABLATE_BITS[n] for n in names)
    need = ABLATE_BITS["noeval"] | ABLATE_BITS["noplace"]
    if bits & ABLATE_BITS["nostage"] and bits & need != need:
        raise ValueError("fused_raster: nostage needs noeval+noplace")
    return bits


def ablate_defines(ablate: str) -> tuple:
    """The preprocessor defines of ``ablate``'s kernel variant: none for
    the production kernel."""
    bits = ablate_bits(ablate)
    return (f"RAINTPU_ABLATE={bits}",) if bits else ()


def kernel_library(ablate: str = ""):
    """The loaded library of ``ablate``'s kernel variant, built from
    csrc/fused_raster.cu on first use (into ``raintpu_torch/_build/``),
    once per variant per process."""
    from raintpu_torch import cuda_build

    lib = cuda_build.load("fused_raster", ablate_defines(ablate))
    if lib.fused_raster_launch.argtypes is None:
        lib.fused_raster_launch.argtypes = (
            [ctypes.POINTER(_RungRecord), ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.fused_raster_launch.restype = ctypes.c_int
        lib.fused_raster_error_string.argtypes = [ctypes.c_int]
        lib.fused_raster_error_string.restype = ctypes.c_char_p
        lib.fused_raster_ablate.argtypes = []
        lib.fused_raster_ablate.restype = ctypes.c_int
    return lib


def _launch(planes: torch.Tensor, rungs: Sequence[RasterRung],
            tex_hw, ablate: str) -> None:
    bsz, n_planes, h, w = planes.shape
    plan = tile_plan((h, w), [(r.ayc.shape[2], r.ayc.shape[3],
                               r.bxc.shape[3]) for r in rungs],
                     bsz, n_planes)
    table = (_RungRecord * len(rungs))(*[
        _RungRecord(r.params.data_ptr(), r.anchor.data_ptr(),
                    r.ayc.data_ptr(), r.bxc.data_ptr(), r.n_valid.data_ptr(),
                    r.params.shape[2], r.ayc.shape[2], r.ayc.shape[3],
                    r.bxc.shape[3], *r.patch_hw) for r in rungs])
    lib = kernel_library(ablate)
    th, tw = tex_hw
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.fused_raster_launch(
            table, len(rungs), planes.data_ptr(), bsz, h, w, n_planes,
            1.0 / th, 1.0 / tw, *plan.tile_hw, *plan.grid, plan.smem_bytes,
            plan.list_cap, plan.coef_floats,
            int(planes.dtype == torch.bfloat16),
            sum(1 << i for i, r in enumerate(rungs) if r.round_first),
            stream)
    if err != 0:
        raise RuntimeError("fused_raster kernel launch failed: "
                           + lib.fused_raster_error_string(err).decode())
    fused_raster_composite.launches += 1
    carried = fused_raster_composite.carried
    windows = tuple(r.patch_hw for r in rungs)
    carried[windows] = carried.get(windows, 0) + 1


def fused_raster_composite(rungs: Sequence[RasterRung], image_hw,
                           tex_hw, n_planes: int = N_PLANES,
                           ablate: str = "",
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Accumulate every rung's drops into fresh (B, n_planes, H, W)
    planes of ``dtype``, float32 or bfloat16 (each rung's contributions
    then rounded by its ``round_first`` rule), n_planes 5, or 8 with
    the saturation planes: the CUDA kernel (one launch for all rungs,
    planned by :func:`tile_plan`, on the current stream, no
    synchronisation) for CUDA tensors, the plain version for CPU
    tensors. At most ``MAX_RUNGS`` rungs, which
    must agree on the batch size and the device.
    ``ablate`` (names of ABLATE_BITS joined by "+", see
    :func:`ablate_bits`) launches a knockout variant of the kernel,
    whose planes are garbage by design: the kernel ablation's tool, on
    CUDA tensors only (a knockout has no plain version). "" is the
    production kernel.
    ``fused_raster_composite.launches`` counts kernel launches, knockout
    variants' included, and ``fused_raster_composite.carried`` counts
    them by the rungs' (ph, pw) windows that each carried (a tuple, in
    rung order)."""
    if not 1 <= len(rungs) <= MAX_RUNGS:
        raise ValueError(f"fused_raster: one call takes 1 to {MAX_RUNGS} "
                         f"rungs, not {len(rungs)}")
    device = rungs[0].params.device
    if ablate_bits(ablate) and device.type != "cuda":
        raise ValueError(f"fused_raster: ablate {ablate!r} exists only in "
                         "the CUDA kernel; no plain version")
    if device.type == "cpu":
        return fused_raster_plain(rungs, image_hw, tex_hw, n_planes,
                                  dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"fused_raster: no kernel for {device.type}")
    _check_rungs(rungs, n_planes)
    _check_dtype(dtype)
    planes = torch.empty((rungs[0].params.shape[0], n_planes)
                         + tuple(image_hw), dtype=dtype, device=device)
    if planes.numel():
        _launch(planes, rungs, tex_hw, ablate)
    return planes


fused_raster_composite.launches = 0
fused_raster_composite.carried = {}
