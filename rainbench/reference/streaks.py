"""The drop half of the render: each drop's inverse warp and defocus,
the damped DCT series of its texture, its window, the ladder of window
sizes fitted to a population, the patches and their composite.

Every drop is rasterized by an inverse map, one 3x3 matrix a drop from
window pixel to texture coordinates: a closed-form homography of the
trapezoid for Big drops, rotate-flip-resize for Small and Medium ones.
The texture is a separable low-rank DCT series; the defocus blur (the
circle of confusion, sigma on rows, sigma/2 on columns) and the pixel
footprint become per-mode Gaussian damping through the warp's Jacobian,
and an axis too blurred for its modes is re-represented on a padded
interval (the modal model). A drop's window is its content plus the
blur's spill; windows go in rungs of a ladder fitted to the population
(the rung's window size, blur radius and series truncation). A patch
pixel is the series clipped to [0, 1] times the tanh-erf content
window, 0 below ALPHA_CUTOFF; a frame's planes sum alpha,
log(max(1 - alpha * lo, LOG_EPS)) and alpha * add_rgb over its drops.

Drops are dicts of (B, N, ...) tensors: ip1, ip2, iw1, iw2, wp1, wp2,
max_width, length, ratio, drop_type and valid, in the parsed convention
of :mod:`rainbench.inputs`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

TYPE_BIG = 0
WARP_EPS = 0.001
COC_PIXSIZE = 4.65e-6
FOCUS_PLANE = 6.0
ALPHA_CUTOFF = 2e-4
LOG_EPS = 1e-6
# Modal blur: quadrature points of the padded interval, and the
# normalized sigma below which the damped model is already exact.
MODAL_S = 64
MODAL_FLOOR = 0.04
# The fitted ladder: rungs at these population quantiles plus a tail
# rung over the max times FIT_TAIL_MARGIN.
FIT_QUANTILES = (0.78, 0.95, 0.995)
FIT_TAIL_MARGIN = 1.15
# Window pixels the patches of one chunk hold at most.
CHUNK_PX = 1 << 24


@dataclasses.dataclass(frozen=True)
class Rung:
    ph: int
    pw: int
    radius: int
    modes_y: int
    modes_x: int
    ranks: int


def tanh_erf(x):
    return torch.tanh(1.1283791671 * x + 0.1009055155 * x * x * x)


def _rows3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def _apply(m, x, y):
    hx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]
    hy = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]
    hz = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2]
    hz = torch.where(torch.abs(hz) < 1e-9, 1e-9, hz)
    return hx / hz, hy / hz


def _big(d, tex_hw, image_wh):
    th, tw = tex_hw
    w_img, h_img = image_wh
    x0, y0 = d["ip1"][..., 0], d["ip1"][..., 1]
    x1, y1 = d["ip2"][..., 0], d["ip2"][..., 1]
    d0, d1 = torch.floor(d["iw1"]), torch.floor(d["iw2"])
    minx = torch.clamp_min(torch.minimum(x0, x1), 0.0)
    miny = torch.clamp_min(torch.minimum(y0, y1), 0.0)
    maxx = torch.clamp_max(torch.maximum(x0 + d0, x1 + d1), float(w_img))
    maxy = torch.clamp_max(torch.maximum(y0, y1), float(h_img))
    w_c = torch.clamp_min(maxx - minx, 1.0)
    h_c = torch.clamp_min(maxy - miny, 1.0)
    xa, ya = x0 - minx, y0 - miny
    xb, yb = x1 - minx + WARP_EPS, y1 - miny
    wths = d0 / torch.clamp_min(d1, WARP_EPS)
    a, c_, f_ = d0 / tw, xa, ya
    g_ = (wths - 1.0) / th
    b_ = (xb * wths - xa) / th
    e = (yb * wths - ya) / th
    z = torch.zeros_like(a)
    m = _rows3([(e - f_ * g_, -(b_ - c_ * g_), b_ * f_ - c_ * e),
                (z, a, -a * f_), (z, -a * g_, a * e)])
    finite = torch.isfinite(m).all(dim=-1).all(dim=-1)
    return minx, miny, w_c, h_c, torch.where(finite[..., None, None], m, 0.0)


def _small(d, tex_hw, image_wh):
    th, tw = tex_hw
    w_img = image_wh[0]
    v = d["ip1"] - d["ip2"]
    n1 = torch.clamp_min(torch.sqrt((v * v).sum(-1)), 1e-9)
    alpha = torch.arccos(torch.clamp(-v[..., 1] / n1, -1.0, 1.0))
    p1 = d["ip1"].to(torch.int32).to(torch.float32)
    p2 = d["ip2"].to(torch.int32).to(torch.float32)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    nw = torch.clamp_min(torch.floor(th * torch.abs(sa) + tw * torch.abs(ca)),
                         1.0)
    nh = torch.clamp_min(torch.floor(th * torch.abs(ca) + tw * torch.abs(sa)),
                         1.0)
    flip = p2[..., 0] > (w_img // 2)
    h_c = torch.clamp_min(torch.abs(p2[..., 1] - p1[..., 1]), 2.0)
    w_c = torch.maximum(torch.abs(p2[..., 0] - p1[..., 0]),
                        d["max_width"].to(torch.float32) + 2.0)
    sx, sy = nw / w_c, nh / h_c
    fsy = torch.where(flip, -sy, sy)
    foy = torch.where(flip, (nh - 1.0) - (0.5 * sy - 0.5), 0.5 * sy - 0.5)
    ox = 0.5 * sx - 0.5
    cx_t, cy_t = tw // 2, th // 2
    z, one = torch.zeros_like(ca), torch.ones_like(ca)
    m = _rows3([(ca * sx, sa * fsy,
                 ca * (ox - nw / 2.0) + sa * (foy - nh / 2.0) + cx_t),
                (-sa * sx, ca * fsy,
                 -sa * (ox - nw / 2.0) + ca * (foy - nh / 2.0) + cy_t),
                (z, z, one)])
    return p1[..., 0], p1[..., 1], w_c, h_c, m


@dataclasses.dataclass
class Geometry:
    m: torch.Tensor           # (B, N, 3, 3) window -> texture
    min_c: torch.Tensor       # (B, N, 2) content origin (x, y)
    wh_c: torch.Tensor        # (B, N, 2) content size
    sigma: torch.Tensor       # (B, N) circle of confusion, px
    shift: torch.Tensor       # (B, N) int32 margin floor(10 sigma)
    band: torch.Tensor        # (B, N, 4) content band (UL, UU, VL, VU)


def geometry(d: Dict[str, torch.Tensor], tex_hw, image_wh, *,
             focal_m: float, f_number: float) -> Geometry:
    """Every drop's inverse warp, content box, defocus and band."""
    th, tw = tex_hw
    bx, by, bw, bh, bm = _big(d, tex_hw, image_wh)
    sx, sy, sw, sh, sm = _small(d, tex_hw, image_wh)
    big = d["drop_type"] == TYPE_BIG
    m = torch.where(big[..., None, None], bm, sm)
    w_c = torch.where(big, bw, sw)
    h_c = torch.where(big, bh, sh)
    o = torch.clamp_min(torch.abs(d["wp1"][..., 2]), 1e-3)
    coc = ((o - FOCUS_PLANE) * focal_m ** 2) / (
        o * (FOCUS_PLANE - focal_m) * f_number)
    sigma = torch.abs(coc / COC_PIXSIZE)

    # The content band: a Big drop's canvas clipped to the frame, in
    # normalized texture coordinates; Small and Medium drops [0, 1].
    cx, cy = (w_c - 1.0) / 2.0, (h_c - 1.0) / 2.0
    tx0, _ = _apply(m, -0.5, cy)
    tx1, _ = _apply(m, w_c - 0.5, cy)
    _, ty0 = _apply(m, cx, -0.5)
    _, ty1 = _apply(m, cx, h_c - 0.5)
    u0, u1 = (tx0 + 0.5) / tw, (tx1 + 0.5) / tw
    v0, v1 = (ty0 + 0.5) / th, (ty1 + 0.5) / th
    band = torch.stack([
        torch.where(big, torch.clamp(torch.minimum(u0, u1), 0.0, 1.0), 0.0),
        torch.where(big, torch.clamp(torch.maximum(u0, u1), 0.0, 1.0), 1.0),
        torch.where(big, torch.clamp(torch.minimum(v0, v1), 0.0, 1.0), 0.0),
        torch.where(big, torch.clamp(torch.maximum(v0, v1), 0.0, 1.0), 1.0),
    ], -1)
    return Geometry(m=m, min_c=torch.stack([torch.where(big, bx, sx),
                                            torch.where(big, by, sy)], -1),
                    wh_c=torch.stack([w_c, h_c], -1), sigma=sigma,
                    shift=torch.floor(10.0 * sigma).to(torch.int32),
                    band=band)


def needs(g: Geometry):
    """Each drop's window: content plus the blur's spill
    floor(4 sigma + 0.5) on both sides, (need_w, need_h), and 4 sigma."""
    spill = torch.floor(4.0 * g.sigma + 0.5)
    return (g.wh_c[..., 0] + 2.0 * spill, g.wh_c[..., 1] + 2.0 * spill,
            4.0 * g.sigma)


# -- the fitted ladder --------------------------------------------------------

def _series(ph: int, radius: int) -> Tuple[int, int, int]:
    if ph <= 48:
        return 12, 6, 3
    if radius >= 16:
        return 16, 8, 4
    return 24, 10, 4


def fit_ladder(nw, nh, s4, valid) -> Tuple[Rung, ...]:
    """Rungs fitted to a population's needs (numpy arrays): window
    heights and widths at the quantiles and the tail, widths snapped
    out to 64 - 2 pad, 128 - 2 pad or a multiple of 128, with pad =
    int(1.25 radius) + 2; a rung as big or bigger than the next in every
    dimension is dropped."""
    nwv, nhv, s4v = nw[valid], nh[valid], s4[valid]
    if nwv.size == 0:
        raise ValueError("no valid drop to fit a ladder to")

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
        pad = int(1.25 * r) + 2
        if pw_raw <= 64 - 2 * pad:
            pw = 64 - 2 * pad
        elif pw_raw <= 128 - 2 * pad:
            pw = 128 - 2 * pad
        else:
            pw = int(-(-pw_raw // 128) * 128)
        return ph, pw, r

    rungs = [rung(q) for q in FIT_QUANTILES + (1.0,)]
    kept = []
    for i, rg in enumerate(rungs):
        if i + 1 < len(rungs):
            nxt = rungs[i + 1]
            if rg[0] >= nxt[0] and rg[1] >= nxt[1] and rg[2] >= nxt[2]:
                continue
        if kept and kept[-1] == rg:
            continue
        kept.append(rg)
    return tuple(Rung(ph, pw, r, *_series(ph, r)) for ph, pw, r in kept)


def route(nw, nh, s4, ladder) -> torch.Tensor:
    """The first rung each drop fits; the last takes the rest."""
    rid = torch.full(nw.shape, len(ladder) - 1, dtype=torch.int32,
                     device=nw.device)
    for i in range(len(ladder) - 2, -1, -1):
        b = ladder[i]
        rid = torch.where((nw <= b.pw) & (nh <= b.ph) & (s4 <= b.radius),
                          i, rid)
    return rid


# -- the damped series --------------------------------------------------------

def _cheb(coefs, xhat):
    """R cosine series (..., C, R, M) at points (..., C, S)."""
    r_, m_ = coefs.shape[-2], coefs.shape[-1]
    t = torch.cos(math.pi * xhat)
    accs = [coefs[..., r, 0, None].expand(xhat.shape) for r in range(r_)]
    prev, cm = torch.ones_like(t), t
    for m in range(1, m_):
        for r in range(r_):
            accs[r] = accs[r] + coefs[..., r, m, None] * cm
        cm, prev = 2.0 * t * cm - prev, cm
    return accs


def _damping(sig, n):
    m = torch.arange(n, dtype=torch.float32, device=sig.device)
    return torch.exp(-0.5 * (math.pi * m * sig[..., None]) ** 2)


def _modal_thresh(modes: int) -> float:
    denom = math.pi * modes - 21.25
    return float("inf") if denom <= 0 else max(MODAL_FLOOR, 2.75 / denom)


def _modal(c, bl, bu, sig):
    """The band-windowed, blurred profile of one axis in the cosine
    basis of [a, a + L], padded 4.25 sigma past the band."""
    m_ = c.shape[-1]
    pad = 4.25 * sig + 0.05
    a = bl - pad
    length = (bu - bl) + 2.0 * pad
    h = length / MODAL_S
    pre = torch.minimum(sig, 1.2 * h)
    post = torch.sqrt(torch.clamp_min(sig ** 2 - pre ** 2, 0.0))
    t = (torch.arange(MODAL_S, dtype=torch.float32, device=c.device)
         + 0.5) / MODAL_S
    q = a[..., None] + t * length[..., None]
    f = torch.stack(_cheb(c * _damping(pre, m_)[..., None, :], q), dim=-2)
    cov = (torch.minimum(bu[..., None], q + 0.5 * h[..., None])
           - torch.maximum(bl[..., None], q - 0.5 * h[..., None]))
    f = f * torch.clamp(cov / torch.clamp_min(h[..., None], 1e-9),
                        0.0, 1.0)[..., None, :]
    kk = torch.arange(m_, dtype=torch.float32, device=c.device)
    ana = torch.cos(math.pi * kk[:, None] * t[None, :])
    d = torch.matmul(f, ana.T) * torch.where(kk == 0, 1.0 / MODAL_S,
                                             2.0 / MODAL_S)
    damp = torch.exp(-0.5 * (math.pi * kk * (post / length)[..., None]) ** 2)
    return d * damp[..., None, :], a, length


def _coefficients(b: Rung, ay, bx, t_sel, m_sel, wh_c, sigma, band, tex_hw):
    """The slots' damped coefficients, their (possibly remapped) warps,
    bands and normalized sigmas."""
    ay = ay[:, :b.ranks, :b.modes_y]
    bx = bx[:, :b.ranks, :b.modes_x]
    my, mx = ay.shape[2], bx.shape[2]
    th, tw = tex_hw
    ayc, bxc = ay[t_sel], bx[t_sel]
    cx, cy = wh_c[..., 0] / 2.0, wh_c[..., 1] / 2.0
    tx0, ty0 = _apply(m_sel, cx, cy)
    txx, tyx = _apply(m_sel, cx + 1.0, cy)
    txy, tyy = _apply(m_sel, cx, cy + 1.0)
    j00, j01, j10, j11 = txx - tx0, txy - tx0, tyx - ty0, tyy - ty0
    s_r, s_c = sigma, sigma / 2.0
    sig_x = torch.sqrt((j00 * s_c) ** 2 + (j01 * s_r) ** 2
                       + (j00 ** 2 + j01 ** 2) / 12.0) / tw
    sig_y = torch.sqrt((j10 * s_c) ** 2 + (j11 * s_r) ** 2
                       + (j10 ** 2 + j11 ** 2) / 12.0) / th
    ul, uu, vl, vu = (band[..., i] for i in range(4))
    ayc_d = ayc * _damping(sig_y, my)[..., None, :]
    bxc_d = bxc * _damping(sig_x, mx)[..., None, :]
    m_out = m_sel
    if math.isfinite(_modal_thresh(mx)):
        use = sig_x > _modal_thresh(mx)
        mo, a_x, l_x = _modal(bxc, ul, uu, sig_x)
        bxc_d = torch.where(use[..., None, None], mo, bxc_d)
        g0 = torch.where(use, 1.0 / l_x, 1.0)
        g1 = torch.where(use, (0.5 - a_x * tw) / l_x - 0.5, 0.0)
        m_out = m_out.clone()
        m_out[..., 0, :] = (m_out[..., 0, :] * g0[..., None]
                            + m_out[..., 2, :] * g1[..., None])
        ul = torch.where(use, 0.0, ul)
        uu = torch.where(use, 1.0, uu)
        sig_x = torch.where(use, 2e-3, sig_x)
    if math.isfinite(_modal_thresh(my)):
        use = sig_y > _modal_thresh(my)
        mo, a_y, l_y = _modal(ayc, vl, vu, sig_y)
        ayc_d = torch.where(use[..., None, None], mo, ayc_d)
        g0 = torch.where(use, 1.0 / l_y, 1.0)
        g1 = torch.where(use, (0.5 - a_y * th) / l_y - 0.5, 0.0)
        m_out = m_out.clone()
        m_out[..., 1, :] = (m_out[..., 1, :] * g0[..., None]
                            + m_out[..., 2, :] * g1[..., None])
        vl = torch.where(use, 0.0, vl)
        vu = torch.where(use, 1.0, vu)
        sig_y = torch.where(use, 2e-3, sig_y)
    return ayc_d, bxc_d, m_out, ul, uu, vl, vu, sig_x, sig_y


def _patches(b: Rung, ay, bx, t_sel, m_sel, wh_c, offx, offy, sigma, band,
             tex_hw):
    """The slots' patches (..., C, PH, PW)."""
    th, tw = tex_hw
    ayc, bxc, m, ul, uu, vl, vu, sx, sy = _coefficients(
        b, ay, bx, t_sel, m_sel, wh_c, sigma, band, tex_hw)
    dev = m.device
    ly = (torch.arange(b.ph, dtype=torch.float32, device=dev)[:, None]
          - offy[..., None, None])
    lx = (torch.arange(b.pw, dtype=torch.float32, device=dev)[None, :]
          - offx[..., None, None])
    mm = m[..., None, None]

    def row(k):
        return mm[..., k, 0, :, :] * lx + mm[..., k, 1, :, :] * ly \
            + mm[..., k, 2, :, :]

    hz = row(2)
    hz = torch.where(torch.abs(hz) < 1e-9, 1e-9, hz)
    xhat = (row(0) / hz + 0.5) / tw
    yhat = (row(1) / hz + 0.5) / th
    ul, uu, vl, vu = (t[..., None, None] for t in (ul, uu, vl, vu))
    sx = torch.clamp_min(sx, 2e-3)[..., None, None]
    sy = torch.clamp_min(sy, 2e-3)[..., None, None]
    r2 = 1.4142135
    win = (0.5 * (tanh_erf((xhat - ul) / (r2 * sx))
                  - tanh_erf((xhat - uu) / (r2 * sx)))
           * 0.5 * (tanh_erf((yhat - vl) / (r2 * sy))
                    - tanh_erf((yhat - vu) / (r2 * sy))))
    mx_, my_ = 0.25 + 4.0 * sx, 0.25 + 4.0 * sy
    win = torch.where((xhat >= ul - mx_) & (xhat <= uu + mx_)
                      & (yhat >= vl - my_) & (yhat <= vu + my_), win, 0.0)
    flat = xhat.shape[:-2] + (b.ph * b.pw,)
    uy = _cheb(ayc, yhat.reshape(flat))
    vx = _cheb(bxc, xhat.reshape(flat))
    g = uy[0] * vx[0]
    for r in range(1, ayc.shape[-2]):
        g = g + uy[r] * vx[r]
    g = torch.clamp(g.reshape(xhat.shape), 0.0, 1.0) * win
    return torch.where(g > ALPHA_CUTOFF, g, 0.0)


def _take(a, idx):
    return torch.take_along_dim(
        a, idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim)),
        dim=idx.ndim - 1)


def fields(d, g: Geometry, tex_idx, ay, bx, tex_hw, image_hw, ladder,
           lo, add_rgb) -> torch.Tensor:
    """The planes (B, 5, H, W): alpha, log-attenuation and the additive
    RGB summed over every valid drop of every frame, each drop in the
    rung its window needs, evaluated on that rung's window at
    clip(content origin - min(shift, radius), 0, image)."""
    h, w = image_hw
    n_fr = d["valid"].shape[0]
    nw, nh, s4 = needs(g)
    rid = route(nw, nh, s4, ladder)
    hp = h + max(b.ph for b in ladder)
    wp = w + max(b.pw for b in ladder)
    planes = torch.zeros((n_fr, 5, hp, wp), dtype=torch.float32,
                         device=lo.device)
    flat = planes.view(-1)
    frame_base = (torch.arange(n_fr, device=lo.device)
                  * (5 * hp * wp))[:, None, None, None]
    plane_base = (torch.arange(5, device=lo.device)
                  * (hp * wp))[:, None, None, None, None]
    for bi, b in enumerate(ladder):
        mask = d["valid"] & (rid == bi)
        n = mask.shape[-1]
        ar = torch.arange(n, device=mask.device).expand(mask.shape)
        idx = torch.sort(torch.where(mask, ar, torch.full_like(ar, n)),
                         dim=-1).values
        n_slots = int(mask.sum(-1).max())
        if n_slots == 0:
            continue
        idx = idx[..., :n_slots]
        ok = idx < n
        idx = idx.clamp(max=n - 1)
        m_sel = _take(g.m, idx)
        minc = _take(g.min_c, idx)
        sigma = torch.clamp_max(_take(g.sigma, idx), b.radius / 4.0)
        shift = torch.clamp_max(_take(g.shift, idx), b.radius)
        wh_c = _take(g.wh_c, idx)
        band = _take(g.band, idx)
        t_sel = _take(tex_idx, idx)
        a = torch.nan_to_num(minc - shift[..., None].to(minc.dtype), nan=0.0)
        ax = torch.clamp(a[..., 0], 0.0, float(w)).to(torch.int32)
        ay_ = torch.clamp(a[..., 1], 0.0, float(h)).to(torch.int32)
        offx = minc[..., 0] - ax.to(minc.dtype)
        offy = minc[..., 1] - ay_.to(minc.dtype)
        lo_s = torch.where(ok, _take(lo, idx), 0.0)
        add_s = torch.where(ok[..., None], _take(add_rgb, idx), 0.0)
        step = max(1, CHUNK_PX // (n_fr * b.ph * b.pw))
        ii = torch.arange(b.ph, device=lo.device)[:, None]
        jj = torch.arange(b.pw, device=lo.device)[None, :]
        for c0 in range(0, n_slots, step):
            cs = slice(c0, min(c0 + step, n_slots))
            p = _patches(b, ay, bx, t_sel[:, cs], m_sel[:, cs], wh_c[:, cs],
                         offx[:, cs], offy[:, cs], sigma[:, cs],
                         band[:, cs], tex_hw)
            p = torch.where(ok[:, cs, None, None], p, 0.0)
            pix = (frame_base + (ay_[:, cs, None, None].to(torch.int64) + ii)
                   * wp + ax[:, cs, None, None].to(torch.int64) + jj)
            vals = [p, torch.log(torch.clamp_min(
                1.0 - p * lo_s[:, cs, None, None], LOG_EPS))]
            vals += [p * add_s[:, cs, k, None, None] for k in range(3)]
            flat.index_add_(0, (plane_base + pix).reshape(-1),
                            torch.stack(vals).reshape(-1))
    return planes[..., :h, :w]
