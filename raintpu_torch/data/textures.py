"""Streak-appearance texture bank (Garg-Nayar rain streak database).

The port's copy of the host side of ``raintpu.data.textures`` (numpy):
the real ``rainstreakdb`` loader (50 16-bit textures, 5 aspect-ratio
bins x 10 oscillation variants, normalized by ``normalized_env_max.txt``),
the procedural bank used when that database is absent, and the
separable low-rank DCT factorization the raster kernel evaluates. Both
banks are resampled onto one (TH, TW) canvas, bin-major, with the
ratio-bin edges kept for texture picks.

:func:`texture_bank` places the bank and its factors on a torch device.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from raintpu_torch import resolve_device

DEFAULT_CANVAS = (256, 32)   # (TH, TW)
TEXTURES_PER_BIN = 10
NUM_BINS = 5


@dataclasses.dataclass
class StreakDatabase:
    """textures: (50, TH, TW) float32 in [0, 1], ordered bin-major
    (bin b occupies rows 10*b .. 10*b+9, matching the reference's
    randint(10*b, 10*b+10) selection).

    bin_edges: (4,) ascending thresholds — drop with ratio < edges[i]
    falls in bin i, else bin 4 (reference ``take_drop_texture``).
    """

    textures: np.ndarray
    bin_edges: np.ndarray
    source: str = "procedural"

    @property
    def canvas(self) -> Tuple[int, int]:
        return self.textures.shape[1], self.textures.shape[2]


def _resample_to_canvas(img: np.ndarray,
                        canvas: Tuple[int, int]) -> np.ndarray:
    """Area-style resample of a 2-D float image onto the common canvas."""
    from PIL import Image

    th, tw = canvas
    pil = Image.fromarray((np.clip(img, 0, 1) * 65535).astype(np.uint16))
    out = pil.resize((tw, th), Image.BILINEAR)
    return np.asarray(out, np.float32) / 65535.0


def load_streak_database(streaks_path: str,
                         norm_coeff_path: str,
                         canvas: Tuple[int, int] = DEFAULT_CANVAS,
                         ) -> StreakDatabase:
    """Load the Garg-Nayar DB (reference ``DBManager.load_streak_database``).

    Files are sorted naturally like the reference's natsorted listing so
    bin-major ordering is preserved.
    """
    from PIL import Image

    norm_coeffs = {}
    with open(norm_coeff_path, "r") as fh:
        lines = fh.readlines()
    coeff = None
    for line in lines:
        if line[:2] == "cv":
            coeff = int(line[2:])
            continue
        norm_coeffs[coeff] = [float(v)
                              for v in line.split("\n")[0].split(" ")[:-1]]

    def natkey(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    files = sorted(os.listdir(streaks_path), key=natkey)
    texs, ratios = [], []
    for fname in files:
        name = os.path.splitext(fname)[0]
        cv_part, osc_part = name.split("_")
        c = int(cv_part[2:])
        osc = int(osc_part[-1:])
        img16 = np.asarray(Image.open(os.path.join(streaks_path, fname)),
                           dtype=np.float64)
        # uint8 truncation round-trip of the reference (:141) then /255.
        img8 = np.floor(255.0 * norm_coeffs[c][osc] * img16 / 65535.0)
        img = np.clip(img8, 0, 255) / 255.0
        ratios.append(img.shape[1] / img.shape[0])
        texs.append(_resample_to_canvas(img, canvas))

    textures = np.stack(texs).astype(np.float32)
    uniq = np.unique(np.asarray(ratios))
    if uniq.shape[0] < NUM_BINS:
        uniq = np.pad(uniq, (0, NUM_BINS - uniq.shape[0]), mode="edge")
    return StreakDatabase(textures=textures,
                          bin_edges=uniq[:4].astype(np.float32),
                          source=streaks_path)


def procedural_streak_database(seed: int = 0,
                               canvas: Tuple[int, int] = DEFAULT_CANVAS,
                               ) -> StreakDatabase:
    """Synthesize a Garg-Nayar-like bank: 5 ratio bins x 10 oscillations.

    Each texture is a vertically elongated streak with a Gaussian
    cross-section whose center wiggles sinusoidally (drop oscillation as
    it falls — Garg & Nayar 2006 model oscillation modes) and a smooth
    axial intensity envelope brightening toward the middle.
    """
    rng = np.random.RandomState(seed)
    th, tw = canvas
    # Nominal aspect ratios (w/h) per bin — thin to thick streaks.
    nominal_ratios = np.array([0.08, 0.16, 0.32, 0.64, 1.28])

    y = np.linspace(0.0, 1.0, th)[:, None]        # axial coordinate
    x = np.arange(tw, dtype=np.float64)[None, :]
    texs = []
    for b in range(NUM_BINS):
        for osc in range(TEXTURES_PER_BIN):
            # Oscillation: lateral displacement of the streak center.
            n_periods = 1.0 + 0.6 * osc
            phase = rng.uniform(0, 2 * np.pi)
            amp = tw * (0.06 + 0.02 * (osc % 3))
            center = tw / 2.0 + amp * np.sin(2 * np.pi * n_periods * y + phase)
            # Cross-section width grows with bin (thicker streaks).
            sigma = tw * (0.10 + 0.05 * b) * (1.0 + 0.15 * np.sin(
                2 * np.pi * n_periods * y + phase + np.pi / 3))
            profile = np.exp(-((x - center) ** 2) / (2.0 * sigma ** 2))
            # Axial envelope: soft fade at both ends + mild speckle.
            envelope = (np.sin(np.pi * y) ** 0.5) * (
                0.75 + 0.25 * np.cos(2 * np.pi * (n_periods * 2) * y + phase))
            tex = profile * envelope
            tex *= 0.55 + 0.1 * rng.uniform()     # peak brightness variety
            texs.append(np.clip(tex, 0.0, 1.0).astype(np.float32))

    # Bin edges: midpoints between nominal ratios (ascending), as the real
    # DB derives unique sorted ratios and thresholds on the first four.
    edges = ((nominal_ratios[:-1] + nominal_ratios[1:])
             / 2.0).astype(np.float32)
    return StreakDatabase(textures=np.stack(texs), bin_edges=edges,
                          source="procedural")


def factorize_streak_db(db: StreakDatabase, rank: int = 4,
                        modes_y: int = 24, modes_x: int = 10):
    """Separable low-rank DCT factorization of the texture bank.

    Each texture is factored tex ~= sum_r u_r(y) * v_r(x) (truncated
    SVD), and each factor expanded in the DCT-II cosine basis
    phi_m(i) = cos(pi*m*(i+0.5)/L). Returns (ay, bx):

        ay: (K, rank, modes_y)   row-axis coefficients
        bx: (K, rank, modes_x)   col-axis coefficients

    so that tex(y, x) ~= sum_r [sum_m ay[m] cos(pi m yhat)] *
                         [sum_n bx[n] cos(pi n xhat)].

    Streak textures are smooth, so a handful of ranks/modes reconstructs
    them to ~1%. As the basis is even-periodic, Gaussian blur of the
    texture is exactly a per-mode damping factor — which is how defocus
    and area-resampling antialiasing are applied without a convolution.
    """
    from scipy.fft import dct

    k, th, tw = db.textures.shape
    ay = np.zeros((k, rank, modes_y), np.float32)
    bx = np.zeros((k, rank, modes_x), np.float32)

    def dct_coefs(x, modes):
        # scipy DCT-II: X_m = 2 sum_n x_n cos(pi m (2n+1)/(2L)); inverse
        # x_n = X0/(2L) + (1/L) sum_{m>=1} X_m cos(pi m (n+0.5)/L).
        X = dct(x, type=2)
        c = np.zeros(modes)
        c[0] = X[0] / (2 * len(x))
        upto = min(modes, len(x))
        c[1:upto] = X[1:upto] / len(x)
        return c

    for i in range(k):
        u, s, vt = np.linalg.svd(db.textures[i], full_matrices=False)
        for r in range(min(rank, len(s))):
            ay[i, r] = dct_coefs(u[:, r] * np.sqrt(s[r]), modes_y)
            bx[i, r] = dct_coefs(vt[r] * np.sqrt(s[r]), modes_x)
    return ay, bx


def get_streak_database(streaks_path: Optional[str] = None,
                        norm_coeff_path: Optional[str] = None,
                        canvas: Tuple[int, int] = DEFAULT_CANVAS,
                        seed: int = 0) -> StreakDatabase:
    """Load the real DB if paths exist, else the procedural fallback."""
    if (streaks_path and norm_coeff_path and os.path.isdir(streaks_path)
            and os.path.exists(norm_coeff_path)):
        return load_streak_database(streaks_path, norm_coeff_path, canvas)
    return procedural_streak_database(seed=seed, canvas=canvas)


@dataclasses.dataclass
class TextureBank:
    """Raw textures plus their separable DCT factors."""

    raw: torch.Tensor   # (K, TH, TW) float32
    ay: torch.Tensor    # (K, R, My) float32 — row-axis DCT coefficients
    bx: torch.Tensor    # (K, R, Mx) float32 — col-axis DCT coefficients

    def to(self, device) -> "TextureBank":
        return TextureBank(raw=self.raw.to(device), ay=self.ay.to(device),
                           bx=self.bx.to(device))


def texture_bank(db: StreakDatabase, rank: int = 6, modes_y: int = 32,
                 modes_x: int = 12, device=None) -> TextureBank:
    """The bank and its DCT factors on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    ay, bx = factorize_streak_db(db, rank=rank, modes_y=modes_y,
                                 modes_x=modes_x)
    return TextureBank(
        raw=torch.as_tensor(db.textures, dtype=torch.float32, device=device),
        ay=torch.as_tensor(ay, dtype=torch.float32, device=device),
        bx=torch.as_tensor(bx, dtype=torch.float32, device=device))
