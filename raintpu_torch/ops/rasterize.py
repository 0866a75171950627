"""Per-drop raster parameters and patches: geometry, routing, damped DCT
series, and the golden path's rasterized patches.

Counterpart of ``raintpu.ops.rasterize``: the parameter contract of the
fused raster+composite kernel (:mod:`raintpu_torch.ops.fused_raster`,
:func:`raster_params_frame`), and the golden render path's patches
(:func:`rasterize_frame_drops`: the same model evaluated patch by patch
in plain PyTorch, the DCT series or a bilinear gather of the textures,
for the scatter composite of :mod:`raintpu_torch.ops.composite`). Every
drop is rasterized by
an inverse map: one 3x3 matrix per drop takes patch coordinates to
texture coordinates (a closed-form homography for Big drops, the
composition rotate∘flip∘resize for Small/Medium drops). The texture is
a separable low-rank DCT series whose Gaussian damping folds in the
defocus blur and the resize footprint; drops are routed into size
rungs ("buckets") so big defocused streaks do not inflate every
drop's window.

Patch-space convention: patch pixel (row i, col j) of a drop with
anchor A shows image pixel A + (j, i); the anchor is the drop's content
origin minus its defocus margin, clipped to the image.

All functions take a leading frame dimension (or none): per-drop arrays
are (..., N, ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from raintpu_torch.ops.blur import variable_separable_blur
from raintpu_torch.ops.fused_raster import (ALPHA_CUTOFF, N_PARAMS, P_ADDB,
                                            P_ADDG, P_ADDR, P_LO, P_SATB,
                                            P_SATG, P_SATR)
from raintpu_torch.particles.schema import (TYPE_BIG, DropBatch,
                                            first_true_indices, take_drops)

WARP_EPS = 0.001  # reference epsilon against singular homographies


def tanh_erf(x):
    """tanh-based erf approximation (max abs err ~3e-3) — the model's
    content window, shared with the kernel (not true erf)."""
    x3 = x * x * x
    return torch.tanh(1.1283791671 * x + 0.1009055155 * x3)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One patch-size class. radius = max blur kernel radius (and
    margin). modes_y/modes_x/ranks truncate the DCT series (0 = all)."""

    ph: int
    pw: int
    radius: int
    capacity: int
    modes_y: int = 0
    modes_x: int = 0
    ranks: int = 0


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    buckets: Tuple[BucketSpec, ...]
    supersample: int = 2
    # The reference hardcodes the CoC pixel size to 4.65e-6 m.
    coc_pixsize: float = 4.65e-6
    # Texture sampling of the golden path (composite_mode "xla"):
    # "fourier" evaluates the DCT series, "gather" bilinearly samples
    # the stored textures (supersample^2 subsamples a pixel) and blurs
    # each drop on its own. The fused path always evaluates the series.
    texture_mode: str = "fourier"
    # Modal blur: heavily defocused drops re-represent each blurred
    # axis profile on a per-drop padded interval (_modal_axis).
    modal_blur: bool = True

    @staticmethod
    def default(capacity: int) -> "RasterConfig":
        return RasterConfig(buckets=(
            BucketSpec(40, 32, 5, capacity, 16, 8),
            BucketSpec(96, 64, 12, max(64, capacity // 2), 24, 10),
            BucketSpec(320, 192, 32, max(32, capacity // 8), 16, 8),
            BucketSpec(704, 384, 48, max(16, capacity // 32), 12, 6),
        ))


def select_textures(drops: DropBatch, bin_edges: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Ratio-binned random texture pick: bin = number of edges <= ratio;
    texture = 10*bin + uniform{0..9}. Draws from ``generator`` (the
    JAX package's per-drop threefry draws cannot be reproduced; tests
    pass them in as data instead)."""
    edges = bin_edges.to(drops.ratio.device)
    bins = (drops.ratio[..., None] >= edges).to(torch.int64).sum(-1)
    offs = torch.randint(0, 10, drops.ratio.shape, generator=generator,
                         device=drops.ratio.device)
    return bins * 10 + offs


def circle_of_confusion(dist: torch.Tensor, *, focal_m: float,
                        f_number: float, focus_plane: float,
                        pixsize: float) -> torch.Tensor:
    """|CoC| in pixels for object distance (m)."""
    o = torch.clamp_min(torch.abs(dist), 1e-3)
    c = ((o - focus_plane) * focal_m ** 2) / (
        o * (focus_plane - focal_m) * f_number)
    return torch.abs(c / pixsize)


def _stack_rows(rows):
    """3x3 matrices from three rows of three (..., N) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def _big_geometry(drops: DropBatch, tex_hw, image_wh):
    """Bbox + inverse homography for Big drops (all N; masked later).

    Returns (minx, miny, w_c, h_c, M) with M the patch->texture 3x3.
    The destination quad is a trapezoid with horizontal top/bottom
    edges, so the 4-point homography has the closed form
    H = [[d0/tw, h12, xa], [0, h22, ya], [0, h32, 1]].
    """
    th, tw = tex_hw
    w_img, h_img = image_wh
    x0, y0 = drops.ip1[..., 0], drops.ip1[..., 1]
    x1, y1 = drops.ip2[..., 0], drops.ip2[..., 1]
    d0 = torch.floor(drops.iw1)
    d1 = torch.floor(drops.iw2)

    minx = torch.clamp_min(torch.minimum(x0, x1), 0.0)
    miny = torch.clamp_min(torch.minimum(y0, y1), 0.0)
    maxx = torch.clamp_max(torch.maximum(x0 + d0, x1 + d1), float(w_img))
    maxy = torch.clamp_max(torch.maximum(y0, y1), float(h_img))
    w_c = torch.clamp_min(maxx - minx, 1.0)
    h_c = torch.clamp_min(maxy - miny, 1.0)

    xa = x0 - minx
    ya = y0 - miny
    xb = x1 - minx + WARP_EPS
    yb = y1 - miny
    d1c = torch.clamp_min(d1, WARP_EPS)  # degenerate bottom edge guard

    wths = d0 / d1c                      # projective weight at y_t = th
    h11 = d0 / tw
    h13 = xa
    h23 = ya
    h32 = (wths - 1.0) / th
    h12 = (xb * wths - xa) / th
    h22 = (yb * wths - ya) / th

    # Inverse (patch -> texture) via the adjugate of
    # [[a, b, c], [0, e, f], [0, g, 1]] (scale cancels in hx/hz).
    a, b_, c_ = h11, h12, h13
    e, f_, g_ = h22, h23, h32
    zeros = torch.zeros_like(a)
    M = _stack_rows([
        (e - f_ * g_, -(b_ - c_ * g_), b_ * f_ - c_ * e),
        (zeros, a, -a * f_),
        (zeros, -a * g_, a * e),
    ])
    finite = torch.isfinite(M).all(dim=-1).all(dim=-1)
    M = torch.where(finite[..., None, None], M, 0.0)
    return minx, miny, w_c, h_c, M


def _sm_geometry(drops: DropBatch, tex_hw, image_wh,
                 noise_deg: torch.Tensor):
    """Closed-form inverse affine for Small/Medium drops (all N):
    rotation from the streak direction (plus wind noise), the
    rotate_bound canvas, an optional vertical flip when the streak sits
    in the right half of the image, then resize to (w_c, h_c).
    Returns (minx, miny, w_c, h_c, M)."""
    th, tw = tex_hw
    w_img, _ = image_wh

    d = drops.ip1 - drops.ip2
    n1 = torch.clamp_min(torch.sqrt((d * d).sum(-1)), 1e-9)
    diry = d[..., 1] / n1
    theta = torch.arccos(torch.clamp(-diry, -1.0, 1.0))  # radians, [0, pi]

    # Wind noise: rotate endpoint coords by `noise` about the midpoint,
    # truncated to int as the reference does, and rotate the texture by
    # theta + noise.
    nz = torch.deg2rad(noise_deg)
    nx, ny = torch.cos(nz), torch.sin(nz)
    mean = (drops.ip1 + drops.ip2) / 2.0

    def jitter(p):
        px = p[..., 0] - mean[..., 0]
        py = p[..., 1] - mean[..., 1]
        rx = px * nx - py * ny + mean[..., 0]
        ry = px * ny + py * nx + mean[..., 1]
        return torch.stack([rx, ry], -1).to(torch.int32).to(torch.float32)

    p1 = jitter(drops.ip1)
    p2 = jitter(drops.ip2)

    alpha = theta + nz                                   # total rotation
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    nW = torch.floor(th * torch.abs(sa) + tw * torch.abs(ca))
    nH = torch.floor(th * torch.abs(ca) + tw * torch.abs(sa))
    nW = torch.clamp_min(nW, 1.0)
    nH = torch.clamp_min(nH, 1.0)

    flip = p2[..., 0] > (w_img // 2)
    h_c = torch.clamp_min(torch.abs(p2[..., 1] - p1[..., 1]), 2.0)
    w_c = torch.maximum(torch.abs(p2[..., 0] - p1[..., 0]),
                        drops.max_width.to(torch.float32) + 2.0)
    minx, miny = p1[..., 0], p1[..., 1]

    # patch (x, y) -> canvas: c = s * p + (0.5*s - 0.5); optional y-flip
    # about (nH-1); canvas -> texture: t = L^T (c - canvas_ctr) + tex_ctr.
    sx = nW / w_c
    sy = nH / h_c
    fsy = torch.where(flip, -sy, sy)
    foy = torch.where(flip, (nH - 1.0) - (0.5 * sy - 0.5), 0.5 * sy - 0.5)
    ox = 0.5 * sx - 0.5

    cx_t, cy_t = tw // 2, th // 2
    a00 = ca * sx
    a01 = sa * fsy
    a02 = ca * (ox - nW / 2.0) + sa * (foy - nH / 2.0) + cx_t
    a10 = -sa * sx
    a11 = ca * fsy
    a12 = -sa * (ox - nW / 2.0) + ca * (foy - nH / 2.0) + cy_t
    zeros = torch.zeros_like(a00)
    ones = torch.ones_like(a00)
    M = _stack_rows([(a00, a01, a02), (a10, a11, a12), (zeros, zeros, ones)])
    return minx, miny, w_c, h_c, M


@dataclasses.dataclass
class DropGeometry:
    """Per-drop raster parameters for a frame (length-N arrays)."""

    M: torch.Tensor           # (..., N, 3, 3) patch-content -> texture
    min_c: torch.Tensor       # (..., N, 2) content anchor (x, y), pre-shift
    content_wh: torch.Tensor  # (..., N, 2) (w_c, h_c)
    sigma: torch.Tensor       # (..., N) defocus CoC (0 when disabled)
    shift: torch.Tensor       # (..., N) int32 reference margin int(10*sigma)
    band: torch.Tensor        # (..., N, 4) (UL, UU, VL, VU) content band


def _apply_h(M, x, y):
    """Texture coords of content-local (x, y) under the 3x3 maps M."""
    hx = M[..., 0, 0] * x + M[..., 0, 1] * y + M[..., 0, 2]
    hy = M[..., 1, 0] * x + M[..., 1, 1] * y + M[..., 1, 2]
    hz = M[..., 2, 0] * x + M[..., 2, 1] * y + M[..., 2, 2]
    hz = torch.where(torch.abs(hz) < 1e-9, 1e-9, hz)
    return hx / hz, hy / hz


def _tex_band(M: torch.Tensor, wh_c: torch.Tensor, is_big: torch.Tensor,
              tex_hw) -> torch.Tensor:
    """Texture-coordinate content band (UL, UU, VL, VU) per drop.

    A Big drop whose quad leaves the frame is warped onto the
    image-clipped canvas and cropped BEFORE the defocus blur; the clip
    is folded into the content window's band: the canvas box mapped
    into normalized texture coords (exact in y; x at the content
    midheight). Small/Medium drops keep the exact [0, 1] band.
    """
    th, tw = tex_hw
    w_c, h_c = wh_c[..., 0], wh_c[..., 1]
    cx = (w_c - 1.0) / 2.0
    cy = (h_c - 1.0) / 2.0
    # Canvas edge pixels' outer faces, in normalized texture coords.
    tx0, _ = _apply_h(M, -0.5, cy)
    tx1, _ = _apply_h(M, w_c - 0.5, cy)
    _, ty0 = _apply_h(M, cx, -0.5)
    _, ty1 = _apply_h(M, cx, h_c - 0.5)
    u0 = (tx0 + 0.5) / tw
    u1 = (tx1 + 0.5) / tw
    v0 = (ty0 + 0.5) / th
    v1 = (ty1 + 0.5) / th

    ul = torch.clamp(torch.minimum(u0, u1), 0.0, 1.0)
    uu = torch.clamp(torch.maximum(u0, u1), 0.0, 1.0)
    vl = torch.clamp(torch.minimum(v0, v1), 0.0, 1.0)
    vu = torch.clamp(torch.maximum(v0, v1), 0.0, 1.0)
    return torch.stack([torch.where(is_big, ul, 0.0),
                        torch.where(is_big, uu, 1.0),
                        torch.where(is_big, vl, 0.0),
                        torch.where(is_big, vu, 1.0)], -1)


def drop_geometry(drops: DropBatch,
                  tex_hw: Tuple[int, int],
                  image_wh: Tuple[int, int],
                  *,
                  focal_m: float,
                  f_number: float,
                  focus_plane: float,
                  coc_pixsize: float,
                  apply_defocus: bool,
                  noise_deg: Optional[torch.Tensor] = None) -> DropGeometry:
    """Every drop's inverse-warp matrix, content anchor and defocus."""
    if noise_deg is None:
        noise_deg = torch.zeros_like(drops.iw1)

    bx, by, bw, bh, bM = _big_geometry(drops, tex_hw, image_wh)
    sx_, sy_, sw, sh, sM = _sm_geometry(drops, tex_hw, image_wh, noise_deg)

    is_big = drops.drop_type == TYPE_BIG
    minx = torch.where(is_big, bx, sx_)
    miny = torch.where(is_big, by, sy_)
    w_c = torch.where(is_big, bw, sw)
    h_c = torch.where(is_big, bh, sh)
    M = torch.where(is_big[..., None, None], bM, sM)

    if apply_defocus:
        sigma = circle_of_confusion(
            drops.wp1[..., 2], focal_m=focal_m, f_number=f_number,
            focus_plane=focus_plane, pixsize=coc_pixsize)
        shift = torch.floor(10.0 * sigma).to(torch.int32)
    else:
        sigma = torch.zeros_like(drops.iw1)
        shift = torch.zeros_like(drops.max_width)

    wh_c = torch.stack([w_c, h_c], -1)
    return DropGeometry(
        M=M, min_c=torch.stack([minx, miny], -1),
        content_wh=wh_c, sigma=sigma, shift=shift,
        band=_tex_band(M, wh_c, is_big, tex_hw))


def _eval_dct_rank_series(coefs: torch.Tensor, xhat: torch.Tensor):
    """R cosine series at arbitrary points via the Chebyshev recurrence
    (cos(m*theta) from cos(theta)). coefs: (..., C, R, M); xhat:
    (..., C, S). Returns a list of R (..., C, S) rank values."""
    r_, m_ = coefs.shape[-2], coefs.shape[-1]
    t = torch.cos(math.pi * xhat)
    accs = [coefs[..., r, 0, None].expand(xhat.shape) for r in range(r_)]
    cm_prev = torch.ones_like(t)
    cm = t
    for m in range(1, m_):
        for r in range(r_):
            accs[r] = accs[r] + coefs[..., r, m, None] * cm
        cm, cm_prev = 2.0 * t * cm - cm_prev, cm
    return accs


def _mode_damping(sigma_hat: torch.Tensor, n_modes: int) -> torch.Tensor:
    """Gaussian blur as spectral damping: mode m scales by
    exp(-(pi*m*sigma_hat)^2 / 2). sigma_hat (..., C) -> (..., C, M)."""
    m = torch.arange(n_modes, dtype=torch.float32, device=sigma_hat.device)
    return torch.exp(-0.5 * (math.pi * m * sigma_hat[..., None]) ** 2)


def _tex_jacobian(m_sel: torch.Tensor, wh_c: torch.Tensor) -> torch.Tensor:
    """Jacobian d(tex)/d(patch) of the inverse map at the content
    center, (..., C, 2, 2) with rows (dtx/dlx, dtx/dly),
    (dty/dlx, dty/dly)."""
    cx = wh_c[..., 0] / 2.0
    cy = wh_c[..., 1] / 2.0
    tx0, ty0 = _apply_h(m_sel, cx, cy)
    txx, tyx = _apply_h(m_sel, cx + 1.0, cy)
    txy, tyy = _apply_h(m_sel, cx, cy + 1.0)
    return torch.stack([
        torch.stack([txx - tx0, txy - tx0], -1),
        torch.stack([tyx - ty0, tyy - ty0], -1),
    ], dim=-2)


# Modal-blur quadrature resolution (samples per padded interval).
MODAL_S = 64
# Below this normalized sigma the classic mirror-damped model is
# already exact to ~1e-3.
MODAL_FLOOR = 0.04


def _modal_thresh(modes: int) -> float:
    """Smallest normalized sigma at which ``modes`` cosine modes on the
    padded interval resolve the damped spectrum; inf when the mode
    budget can never cover it."""
    denom = math.pi * modes - 21.25
    if denom <= 0:
        return float("inf")
    return max(MODAL_FLOOR, 2.75 / denom)


def _modal_axis(c, bl, bu, sig):
    """Exact-blur re-representation of one axis profile.

    c: (..., C, R, M) cosine coefficients on [0, 1]; bl/bu: (..., C)
    content band; sig: (..., C) normalized blur std. Returns (c2, a, L):
    coefficients of the blurred band-windowed profile in the cosine
    basis of [a, a+L], an interval padded 4.25 sigma past the band so
    per-mode damping on it is the compact blur.
    """
    m_ = c.shape[-1]
    s_pts = MODAL_S
    pad = 4.25 * sig + 0.05
    a = bl - pad
    length = (bu - bl) + 2.0 * pad

    # Anti-alias split: sig^2 = sig_pre^2 + sig_post^2.
    h = length / s_pts
    sig_pre = torch.minimum(sig, 1.2 * h)
    sig_post = torch.sqrt(torch.clamp_min(sig ** 2 - sig_pre ** 2, 0.0))
    c_pre = c * _mode_damping(sig_pre, m_)[..., None, :]

    # Per-drop synthesis at quadrature points (..., C, R, S).
    t = (torch.arange(s_pts, dtype=torch.float32, device=c.device)
         + 0.5) / s_pts
    q = a[..., None] + t * length[..., None]
    f = torch.stack(_eval_dct_rank_series(c_pre, q), dim=-2)

    # Band window at fractional-coverage (box) resolution.
    cov = (torch.minimum(bu[..., None], q + 0.5 * h[..., None])
           - torch.maximum(bl[..., None], q - 0.5 * h[..., None]))
    cov = torch.clamp(cov / torch.clamp_min(h[..., None], 1e-9), 0.0, 1.0)
    f = f * cov[..., None, :]

    # DCT-II analysis back to M modes, then padded-interval damping
    # with the remaining blur.
    kk = torch.arange(m_, dtype=torch.float32, device=c.device)
    ana = torch.cos(math.pi * kk[:, None] * t[None, :])   # (M, S)
    scale = torch.where(kk == 0, 1.0 / s_pts, 2.0 / s_pts)
    d = torch.matmul(f, ana.T) * scale
    damp = torch.exp(-0.5 * (math.pi * kk
                             * (sig_post / length)[..., None]) ** 2)
    return d * damp[..., None, :], a, length


def fourier_drop_coefficients(b: BucketSpec, fourier, t_sel, m_sel,
                              wh_c, sigma, tex_hw, apply_defocus: bool,
                              band=None, modal: bool = True):
    """Per-drop damped DCT coefficients + window parameters.

    Defocus blur (sigma rows, sigma/2 cols in patch space) and the
    pixel-footprint antialiasing (box variance J^2/12) become per-mode
    Gaussian damping through the warp Jacobian (CLASSIC model). Axes
    whose normalized sigma exceeds _modal_thresh switch to the MODAL
    model: the band-windowed profile re-represented on a padded
    interval (_modal_axis), with the affine remap folded into the
    homography row and a sharp band cut in place of the erf window.

    Returns (ayc, bxc, m_out, ul, uu, vl, vu, sig_x, sig_y).
    """
    ay, bx = fourier
    if b.ranks:
        ay = ay[:, :b.ranks]
        bx = bx[:, :b.ranks]
    if b.modes_y:
        ay = ay[:, :, :b.modes_y]
    if b.modes_x:
        bx = bx[:, :, :b.modes_x]
    m_modes = ay.shape[2]
    n_modes = bx.shape[2]
    th, tw = tex_hw

    # The JAX package picks rows with a one-hot matmul (no TPU gather);
    # a gather gives the same values.
    ayc = ay[t_sel]                                     # (..., C, R, My)
    bxc = bx[t_sel]

    jac = _tex_jacobian(m_sel, wh_c)                    # (..., C, 2, 2)
    s_rows = sigma if apply_defocus else torch.zeros_like(sigma)
    s_cols = s_rows / 2.0
    j00, j01 = jac[..., 0, 0], jac[..., 0, 1]
    j10, j11 = jac[..., 1, 0], jac[..., 1, 1]
    var_tx = ((j00 * s_cols) ** 2 + (j01 * s_rows) ** 2
              + (j00 ** 2 + j01 ** 2) / 12.0)
    var_ty = ((j10 * s_cols) ** 2 + (j11 * s_rows) ** 2
              + (j10 ** 2 + j11 ** 2) / 12.0)
    sig_xhat = torch.sqrt(var_tx) / tw
    sig_yhat = torch.sqrt(var_ty) / th

    if band is None:
        ul = vl = torch.zeros_like(sig_xhat)
        uu = vu = torch.ones_like(sig_xhat)
    else:
        ul, uu, vl, vu = (band[..., i] for i in range(4))

    ayc_cl = ayc * _mode_damping(sig_yhat, m_modes)[..., None, :]
    bxc_cl = bxc * _mode_damping(sig_xhat, n_modes)[..., None, :]
    m_out = m_sel

    thx = _modal_thresh(n_modes)
    thy = _modal_thresh(m_modes)
    if modal and math.isfinite(thx):
        use = sig_xhat > thx
        bxc_mo, a_x, l_x = _modal_axis(bxc, ul, uu, sig_xhat)
        bxc_cl = torch.where(use[..., None, None], bxc_mo, bxc_cl)
        # Fold xhat -> (xhat - a)/L into homography row 0:
        # hx' = hx/L + hz * ((0.5 - a*tw)/L - 0.5).
        g0 = torch.where(use, 1.0 / l_x, 1.0)
        g1 = torch.where(use, (0.5 - a_x * tw) / l_x - 0.5, 0.0)
        m_out = m_out.clone()
        m_out[..., 0, :] = (m_out[..., 0, :] * g0[..., None]
                            + m_out[..., 2, :] * g1[..., None])
        ul = torch.where(use, 0.0, ul)
        uu = torch.where(use, 1.0, uu)
        sig_xhat = torch.where(use, 2e-3, sig_xhat)
    if modal and math.isfinite(thy):
        use = sig_yhat > thy
        ayc_mo, a_y, l_y = _modal_axis(ayc, vl, vu, sig_yhat)
        ayc_cl = torch.where(use[..., None, None], ayc_mo, ayc_cl)
        g0 = torch.where(use, 1.0 / l_y, 1.0)
        g1 = torch.where(use, (0.5 - a_y * th) / l_y - 0.5, 0.0)
        m_out = m_out.clone()
        m_out[..., 1, :] = (m_out[..., 1, :] * g0[..., None]
                            + m_out[..., 2, :] * g1[..., None])
        vl = torch.where(use, 0.0, vl)
        vu = torch.where(use, 1.0, vu)
        sig_yhat = torch.where(use, 2e-3, sig_yhat)

    return (ayc_cl, bxc_cl, m_out, ul, uu, vl, vu, sig_xhat, sig_yhat)


def _route_buckets(drops: DropBatch, geom: DropGeometry,
                   cfg: RasterConfig) -> torch.Tensor:
    """Assign every drop to the first bucket it fits (blur spill
    included); the last bucket takes the remainder (clipped)."""
    spill = torch.floor(4.0 * geom.sigma + 0.5).to(torch.int32)
    need_w = geom.content_wh[..., 0] + 2.0 * spill.to(torch.float32)
    need_h = geom.content_wh[..., 1] + 2.0 * spill.to(torch.float32)
    bucket_id = torch.full(drops.valid.shape, len(cfg.buckets) - 1,
                           dtype=torch.int32, device=drops.valid.device)
    for bi in range(len(cfg.buckets) - 2, -1, -1):
        b = cfg.buckets[bi]
        fits = ((need_w <= b.pw) & (need_h <= b.ph)
                & (geom.sigma * 4.0 <= b.radius))
        bucket_id = torch.where(fits, bi, bucket_id)
    return bucket_id


# The golden path evaluates patches in chunks of at most this many
# window pixels (all frames' slots of a chunk at once), so its
# transient (chunk, PH, PW) tensors stay bounded on the big rungs.
PATCH_CHUNK_PX = 1 << 24


@dataclasses.dataclass
class RasterBucket:
    """Rasterized (and blurred) drops of one size bucket, per frame."""

    patches: torch.Tensor   # (..., C, PH, PW) float32 blurred gray in [0, 1]
    anchor: torch.Tensor    # (..., C, 2) int32 image (x, y) of patch origin
    drop_idx: torch.Tensor  # (..., C) int64 index into the frame's drops
    valid: torch.Tensor     # (..., C) bool
    overflow: torch.Tensor  # (...,) int32 drops that did not fit capacity


def _sample_texture(textures: torch.Tensor, tex_idx: torch.Tensor,
                    tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with a zero border. textures (K, TH, TW); tex_idx
    (..., C); tx/ty (..., C, PH, PW) -> (..., C, PH, PW)."""
    _, th, tw = textures.shape
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    idx = tex_idx.to(torch.int64)[..., None, None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < tw) & (yi >= 0) & (yi < th)
        vals = textures[idx, yi.clamp(0, th - 1), xi.clamp(0, tw - 1)]
        return torch.where(inb, vals, 0.0)

    return ((1 - fx) * (1 - fy) * tap(x0i, y0i)
            + fx * (1 - fy) * tap(x0i + 1, y0i)
            + (1 - fx) * fy * tap(x0i, y0i + 1)
            + fx * fy * tap(x0i + 1, y0i + 1))


def _patch_tex_coords(ph, pw, m_sel, offx, offy, sub_y=0.0, sub_x=0.0):
    """Content-local coords and texture coords of every patch pixel:
    (lx, ly, tx, ty), each broadcastable to (..., C, PH, PW). ``offx``/
    ``offy`` (..., C): the content's start in the patch; ``sub_y``/
    ``sub_x``: a subsample's offset in pixels."""
    dev = m_sel.device
    ii = torch.arange(ph, dtype=torch.float32, device=dev) + sub_y
    jj = torch.arange(pw, dtype=torch.float32, device=dev) + sub_x
    ly = ii[:, None] - offy[..., None, None]            # (..., C, PH, 1)
    lx = jj[None, :] - offx[..., None, None]            # (..., C, 1, PW)
    m = m_sel[..., None, None]

    def row(k):
        return (m[..., k, 0, :, :] * lx + m[..., k, 1, :, :] * ly
                + m[..., k, 2, :, :])

    hx, hy, hz = row(0), row(1), row(2)
    hz = torch.where(torch.abs(hz) < 1e-9, 1e-9, hz)
    return lx, ly, hx / hz, hy / hz


def _raster_bucket_gather(b: BucketSpec, supersample, textures, t_sel,
                          m_sel, wh_c, offx, offy) -> torch.Tensor:
    """Supersampled bilinear gather of the stored textures: the mean of
    ``supersample``^2 subsamples a pixel (accumulated at (PH, PW)), each
    zero outside the content rect, clipped to [0, 1] as the reference
    clips after its warp."""
    s = supersample
    g = None
    for sy in range(s):
        for sx in range(s):
            dy = (sy + 0.5) / s - 0.5
            dx = (sx + 0.5) / s - 0.5
            lx, ly, tx, ty = _patch_tex_coords(b.ph, b.pw, m_sel, offx,
                                               offy, dy, dx)
            inside = ((lx > -0.5) & (lx < wh_c[..., 0, None, None] - 0.5)
                      & (ly > -0.5) & (ly < wh_c[..., 1, None, None] - 0.5))
            sample = torch.where(inside,
                                 _sample_texture(textures, t_sel, tx, ty),
                                 0.0)
            g = sample if g is None else g + sample
    return torch.clamp(g / (s * s), 0.0, 1.0)


def _raster_bucket_fourier(b: BucketSpec, fourier, t_sel, m_sel, wh_c,
                           offx, offy, sigma, tex_hw, apply_defocus: bool,
                           band=None, modal: bool = True) -> torch.Tensor:
    """Analytic rasterization from the separable DCT streak bank: one
    cosine-series evaluation a pixel (see fourier_drop_coefficients for
    the damping), times the tanh-erf content window — the blurred
    indicator of the content band in normalized texture coordinates,
    hard-cut at 4 sigma + 0.25 — clipped, and 0 below ALPHA_CUTOFF."""
    th, tw = tex_hw
    (ayc, bxc, m_out, ul, uu, vl, vu, sig_x, sig_y) = \
        fourier_drop_coefficients(b, fourier, t_sel, m_sel, wh_c, sigma,
                                  tex_hw, apply_defocus, band=band,
                                  modal=modal)
    _, _, tx, ty = _patch_tex_coords(b.ph, b.pw, m_out, offx, offy)
    xhat = (tx + 0.5) / tw
    yhat = (ty + 0.5) / th
    ul, uu, vl, vu = (t[..., None, None] for t in (ul, uu, vl, vu))

    erf = tanh_erf
    sqrt2 = 1.4142135
    sx = torch.clamp_min(sig_x, 2e-3)[..., None, None]
    sy = torch.clamp_min(sig_y, 2e-3)[..., None, None]
    win = (0.5 * (erf((xhat - ul) / (sqrt2 * sx))
                  - erf((xhat - uu) / (sqrt2 * sx)))
           * 0.5 * (erf((yhat - vl) / (sqrt2 * sy))
                    - erf((yhat - vu) / (sqrt2 * sy))))
    mx = 0.25 + 4.0 * sx
    my = 0.25 + 4.0 * sy
    win = torch.where((xhat >= ul - mx) & (xhat <= uu + mx)
                      & (yhat >= vl - my) & (yhat <= vu + my), win, 0.0)

    flat = xhat.shape[:-2] + (b.ph * b.pw,)
    uy = _eval_dct_rank_series(ayc, yhat.reshape(flat))
    vx = _eval_dct_rank_series(bxc, xhat.reshape(flat))
    g = uy[0] * vx[0]
    for r in range(1, ayc.shape[-2]):
        g = g + uy[r] * vx[r]
    g = torch.clamp(g.reshape(xhat.shape), 0.0, 1.0) * win
    return torch.where(g > ALPHA_CUTOFF, g, 0.0)


def rasterize_frame_drops(drops: DropBatch,
                          geom: DropGeometry,
                          textures: torch.Tensor,
                          tex_idx: torch.Tensor,
                          image_wh: Tuple[int, int],
                          cfg: RasterConfig,
                          apply_defocus: bool,
                          fourier=None) -> Tuple[RasterBucket, ...]:
    """Route drops into size buckets and rasterize (and defocus) each
    bucket's patches: the golden render path's raster.

    ``drops``: one frame (N, ...) or a batch (B, N, ...); ``textures``:
    the raw (K, TH, TW) bank. With cfg.texture_mode "fourier" and
    ``fourier`` = (ay, bx) DCT coefficients (K, R, My) / (K, R, Mx), the
    patches are the analytic series (:func:`_raster_bucket_fourier`),
    its damping the defocus; else the bilinear gather of the textures
    (:func:`_raster_bucket_gather`) followed, under defocus, by the
    per-drop Gaussian :func:`variable_separable_blur` (sigma rows,
    sigma/2 columns). A bucket's slots hold its drops in ascending drop
    index; slots past the fullest frame's valid ones are zeros without
    being evaluated, and every invalid slot's patch is 0.
    Returns one :class:`RasterBucket` per cfg.buckets entry.
    """
    w_img, h_img = image_wh
    bucket_id = _route_buckets(drops, geom, cfg)
    gather = cfg.texture_mode != "fourier" or fourier is None

    out = []
    for bi, b in enumerate(cfg.buckets):
        mask = drops.valid & (bucket_id == bi)
        idx, sel_valid, overflow = first_true_indices(mask, b.capacity)

        m_sel = take_drops(geom.M, idx)
        minc = take_drops(geom.min_c, idx)
        sigma = torch.clamp_max(take_drops(geom.sigma, idx), b.radius / 4.0)
        shift = torch.clamp_max(take_drops(geom.shift, idx), b.radius)
        wh_c = take_drops(geom.content_wh, idx)
        t_sel = take_drops(tex_idx, idx)
        band = take_drops(geom.band, idx)

        # Patch anchor clip(minC - shift, 0, image) and the content's
        # start in the patch (the reference's delta-crop). An invalid
        # slot's NaN anchor becomes 0, as XLA converts it, so that the
        # scatter's indices stay inside the planes.
        a = torch.nan_to_num(minc - shift[..., None].to(minc.dtype), nan=0.0)
        ax = torch.clamp(a[..., 0], 0.0, float(w_img)).to(torch.int32)
        ay = torch.clamp(a[..., 1], 0.0, float(h_img)).to(torch.int32)
        offx = minc[..., 0] - ax.to(minc.dtype)
        offy = minc[..., 1] - ay.to(minc.dtype)

        lead = sel_valid.shape[:-1]
        patches = torch.zeros(lead + (b.capacity, b.ph, b.pw),
                              dtype=torch.float32, device=idx.device)
        n_eval = int(sel_valid.sum(-1).max()) if sel_valid.numel() else 0
        frames = max(1, math.prod(lead))
        step = max(1, PATCH_CHUNK_PX // (frames * b.ph * b.pw))
        for c0 in range(0, n_eval, step):
            cs = slice(c0, min(c0 + step, n_eval))

            def part(t, trailing=0):
                return t[(Ellipsis, cs) + (slice(None),) * trailing]

            if gather:
                g = _raster_bucket_gather(
                    b, cfg.supersample, textures, part(t_sel),
                    part(m_sel, 2), part(wh_c, 1), part(offx), part(offy))
                if apply_defocus:
                    s = part(sigma).reshape(-1)
                    g = variable_separable_blur(
                        g.reshape(-1, b.ph, b.pw), s, s / 2.0,
                        b.radius).reshape(g.shape)
            else:
                g = _raster_bucket_fourier(
                    b, fourier, part(t_sel), part(m_sel, 2), part(wh_c, 1),
                    part(offx), part(offy), part(sigma),
                    tuple(textures.shape[1:]), apply_defocus,
                    band=part(band, 1), modal=cfg.modal_blur)
            # where(), not a product: a degenerate slot's NaN must not
            # survive as NaN * 0.
            patches[..., cs, :, :] = torch.where(
                part(sel_valid)[..., None, None], g, 0.0)
        out.append(RasterBucket(
            patches=patches, anchor=torch.stack([ax, ay], -1),
            drop_idx=idx, valid=sel_valid, overflow=overflow.to(torch.int32)))
    return tuple(out)


@dataclasses.dataclass
class RungParams:
    """One rung's operands for the fused kernel, per frame (B, ...)."""

    params: torch.Tensor    # (B, N_PARAMS, C) float32, P_* row layout
    anchor: torch.Tensor    # (B, C, 2) int32 patch origin (x, y)
    ayc: torch.Tensor       # (B, C, R, My) float32 damped row coefficients
    bxc: torch.Tensor       # (B, C, R, Mx) float32 damped col coefficients
    drop_idx: torch.Tensor  # (B, C) int64 index into the frame's drops
    valid: torch.Tensor     # (B, C) bool
    overflow: torch.Tensor  # (B,) int32 drops that did not fit capacity


def raster_params_frame(drops: DropBatch,
                        geom: DropGeometry,
                        tex_hw,
                        tex_idx: torch.Tensor,
                        image_wh,
                        cfg: RasterConfig,
                        apply_defocus: bool,
                        fourier) -> list:
    """Per-rung operands of the fused kernel: the geometry rows of the
    (N_PARAMS, C) param matrix (blend rows stay zero for the caller),
    the patch anchor clip(minC - shift) and the damped DCT
    coefficients. No patch is materialized. Returns a list of
    :class:`RungParams`, one per cfg.buckets entry."""
    w_img, h_img = image_wh
    bucket_id = _route_buckets(drops, geom, cfg)

    out = []
    for bi, b in enumerate(cfg.buckets):
        mask = drops.valid & (bucket_id == bi)
        # Slots hold the rung's drops in ascending drop index.
        idx, sel_valid, overflow = first_true_indices(mask, b.capacity)

        m_sel = take_drops(geom.M, idx)
        minc = take_drops(geom.min_c, idx)
        sigma = torch.clamp_max(take_drops(geom.sigma, idx), b.radius / 4.0)
        shift = torch.clamp_max(take_drops(geom.shift, idx), b.radius)
        wh_c = take_drops(geom.content_wh, idx)
        t_sel = take_drops(tex_idx, idx)

        # Patch anchor: clip(minC - shift, 0, image), truncated to int.
        a = minc - shift[..., None].to(minc.dtype)
        ax = torch.clamp(a[..., 0], 0.0, float(w_img)).to(torch.int32)
        ay = torch.clamp(a[..., 1], 0.0, float(h_img)).to(torch.int32)

        (ayc, bxc, m_out, ul, uu, vl, vu, sig_x, sig_y) = \
            fourier_drop_coefficients(
                b, fourier, t_sel, m_sel, wh_c, sigma, tex_hw,
                apply_defocus, band=take_drops(geom.band, idx),
                modal=cfg.modal_blur)
        # Zero the coefficients of invalid slots (on top of the
        # kernel's count gate).
        ayc = torch.where(sel_valid[..., None, None], ayc, 0.0)

        m = m_out.reshape(m_out.shape[:-2] + (9,))
        zeros = torch.zeros_like(sig_x)
        rows = ([m[..., k] for k in range(9)]
                + [minc[..., 0], minc[..., 1], wh_c[..., 0], wh_c[..., 1],
                   sig_x, sig_y]
                + [zeros] * 4     # lo, add_rgb (caller fills)
                + [zeros] * 3     # sat_rgb (caller fills)
                + [ul, uu, vl, vu])
        assert len(rows) == N_PARAMS
        out.append(RungParams(
            params=torch.stack(rows, dim=-2).contiguous(),
            anchor=torch.stack([ax, ay], -1).contiguous(),
            ayc=ayc.contiguous(), bxc=bxc.contiguous(), drop_idx=idx,
            valid=sel_valid, overflow=overflow.to(torch.int32)))
    return out


def _fit_series(ph: int, radius: int) -> Tuple[int, int, int]:
    """(modes_y, modes_x, ranks) series truncation for a fitted rung:
    small patches carry no high-frequency content worth evaluating,
    heavily defocused big ones have their high modes damped to ~0, and
    the SVD rank axis is energy-ordered (the JAX package's choice,
    ``raintpu/ops/rasterize.py:949``)."""
    if ph <= 48:
        return 12, 6, 3
    if radius >= 16:
        return 16, 8, 4
    return 24, 10, 4


# The fitted ladder's rungs sit at these quantiles of the sampled
# population, plus a tail rung over the sampled max times FIT_TAIL_MARGIN;
# capacities are the per-frame max occupancy times FIT_HEADROOM plus
# FIT_SLACK (the JAX package's defaults).
FIT_QUANTILES = (0.78, 0.95, 0.995)
FIT_HEADROOM = 1.3
FIT_SLACK = 16
FIT_TAIL_MARGIN = 1.15


def fit_needs(drops: DropBatch, tex_hw, image_wh, settings):
    """Each drop's needed window (content + 4-sigma blur spill, the
    ``_route_buckets`` formula) and 4 sigma, as (nw, nh, s4) tensors
    shaped like ``drops.valid``, on the drops' device. With streak noise
    the needs are the largest over noise 0 and +-3 noise std."""
    cam = settings.camera
    physics = settings.rendering_strategy is None
    noise_max = 3.0 * float(settings.noise_std) * float(settings.noise_scale)

    def needs_at(noise_deg):
        g = drop_geometry(
            drops, tuple(tex_hw), tuple(image_wh), focal_m=cam.focal_m,
            f_number=cam.f_number, focus_plane=settings.focus_plane,
            coc_pixsize=4.65e-6, apply_defocus=physics,
            noise_deg=torch.full_like(drops.iw1, noise_deg))
        spill = torch.floor(4.0 * g.sigma + 0.5)
        return (g.content_wh[..., 0] + 2.0 * spill,
                g.content_wh[..., 1] + 2.0 * spill, 4.0 * g.sigma)

    nw, nh, s4 = needs_at(0.0)
    if noise_max > 0.0:
        for nz in (-noise_max, noise_max):
            nw2, nh2, s42 = needs_at(nz)
            nw = torch.maximum(nw, nw2)
            nh = torch.maximum(nh, nh2)
            s4 = torch.maximum(s4, s42)
    return nw, nh, s4


def fit_raster_config(drops: DropBatch, tex_hw, image_wh,
                      settings) -> RasterConfig:
    """Fit a bucket ladder to a sampled drop population.

    ``drops``: a batched (B, N) DropBatch sample; its needs
    (:func:`fit_needs`) are computed on its device, the ladder from them
    on the host with numpy, as the JAX package's ``fit_raster_config``
    does, so both give the same ladder. Rungs go at population quantiles
    (FIT_QUANTILES), widths snap out to their cost-free bounds, rungs an
    equal-or-bigger earlier rung would shadow are dropped, and each
    rung's capacity covers the sample's per-frame occupancy under
    first-fit routing. The last rung covers the sampled max times
    FIT_TAIL_MARGIN (drops beyond it are clipped to it; the overflow
    counters still fire on capacity misfits). ``settings``: a
    RenderSettings (camera, focus_plane, rendering_strategy, noise).
    An empty sample gives the default ladder at capacity 64.
    """
    nw, nh, s4 = (t.cpu().numpy()
                  for t in fit_needs(drops, tex_hw, image_wh, settings))
    v = drops.valid.cpu().numpy().astype(bool)
    if not v.any():
        return RasterConfig(buckets=RasterConfig.default(64).buckets)
    nwv, nhv, s4v = nw[v], nh[v], s4[v]

    def rung(q):
        if q >= 1.0:
            ph_raw = float(nhv.max()) * FIT_TAIL_MARGIN
            pw_raw = float(nwv.max()) * FIT_TAIL_MARGIN
            r = int(np.ceil(s4v.max() * FIT_TAIL_MARGIN))
        else:
            ph_raw = float(np.quantile(nhv, q))
            pw_raw = float(np.quantile(nwv, q))
            r = int(np.ceil(np.quantile(s4v, q)))
        r = max(r, 2)
        ph = int(-(-max(ph_raw, 8.0) // 8) * 8)
        # Width snapping (cost-free widening on the TPU). LANE=128 and
        # the bounds mirror ops/pallas/fused_kernel + render/frame's
        # strip/pair eligibility: pad = 1.25*radius + 2.
        # The PAIR bound (64 - 2*pad) comes first: a rung at or under
        # it evaluates two drops per series eval (the kernel's VPU
        # roofline), so widening past it is NOT free — only widening
        # up to it, or between it and the strip bound, is.
        pad = int(1.25 * r) + 2
        pair_bound = 64 - 2 * pad
        strip_bound = 128 - 2 * pad
        if pw_raw <= pair_bound:
            pw = pair_bound
        elif pw_raw <= strip_bound:
            pw = strip_bound
        else:
            pw = int(-(-pw_raw // 128) * 128)
        return ph, pw, r

    rungs = [rung(q) for q in FIT_QUANTILES + (1.0,)]
    # Deduplicate: keep a rung only if it is strictly smaller than the
    # next in some dimension (first-fit makes an equal-or-bigger
    # earlier rung shadow the later one).
    kept = []
    for i, rg in enumerate(rungs):
        if i + 1 < len(rungs):
            nxt = rungs[i + 1]
            if rg[0] >= nxt[0] and rg[1] >= nxt[1] and rg[2] >= nxt[2]:
                continue
        if kept and kept[-1] == rg:
            continue
        kept.append(rg)

    # First-fit routing (the _route_buckets formula) -> per-frame max
    # occupancy -> capacities.
    bid = np.full(nw.shape, len(kept) - 1, np.int32)
    for bi in range(len(kept) - 2, -1, -1):
        ph, pw, r = kept[bi]
        fit = (nw <= pw) & (nh <= ph) & (s4 <= r)
        bid = np.where(fit, bi, bid)
    specs = []
    for bi, (ph, pw, r) in enumerate(kept):
        occ = int(((bid == bi) & v).sum(axis=1).max())
        cap = max(8, int(occ * FIT_HEADROOM) + FIT_SLACK)
        cap = int(-(-cap // 8) * 8)
        specs.append(BucketSpec(ph, pw, r, cap, *_fit_series(ph, r)))
    return RasterConfig(buckets=tuple(specs))


def fill_blend_rows(rung: RungParams, lo: torch.Tensor,
                    add_rgb: torch.Tensor,
                    sat_rgb: Optional[torch.Tensor] = None) -> None:
    """Fill a rung's blend rows (in place) from per-frame-drop arrays
    lo (..., N) and add_rgb (..., N, 3), and its saturation rows from
    the pre-tau drop colors sat_rgb (..., N, 3) when given (else they
    stay 0); invalid slots get 0."""
    v = rung.valid
    p = rung.params

    def rows(x):
        return torch.where(v, take_drops(x, rung.drop_idx), 0.0)

    p[..., P_LO, :] = rows(lo)
    p[..., P_ADDR, :] = rows(add_rgb[..., 0])
    p[..., P_ADDG, :] = rows(add_rgb[..., 1])
    p[..., P_ADDB, :] = rows(add_rgb[..., 2])
    if sat_rgb is not None:
        p[..., P_SATR, :] = rows(sat_rgb[..., 0])
        p[..., P_SATG, :] = rows(sat_rgb[..., 1])
        p[..., P_SATB, :] = rows(sat_rgb[..., 2])
