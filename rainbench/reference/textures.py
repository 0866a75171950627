"""The separable low-rank DCT factors of a streak texture bank: each
texture's truncated SVD, each factor's DCT-II coefficients, so that
tex(y, x) ~ sum_r [sum_m ay[r, m] cos(pi m yhat)] [sum_n bx[r, n]
cos(pi n xhat)]."""

from __future__ import annotations

import numpy as np

RANK, MODES_Y, MODES_X = 6, 32, 12


def _dct(x: np.ndarray, modes: int) -> np.ndarray:
    from scipy.fft import dct

    big = dct(x, type=2)
    c = np.zeros(modes)
    c[0] = big[0] / (2 * len(x))
    upto = min(modes, len(x))
    c[1:upto] = big[1:upto] / len(x)
    return c


def factors(textures: np.ndarray):
    """(K, TH, TW) -> (ay (K, RANK, MODES_Y), bx (K, RANK, MODES_X))."""
    k = textures.shape[0]
    ay = np.zeros((k, RANK, MODES_Y), np.float32)
    bx = np.zeros((k, RANK, MODES_X), np.float32)
    for i in range(k):
        u, s, vt = np.linalg.svd(textures[i], full_matrices=False)
        for r in range(min(RANK, len(s))):
            ay[i, r] = _dct(u[:, r] * np.sqrt(s[r]), MODES_Y)
            bx[i, r] = _dct(vt[r] * np.sqrt(s[r]), MODES_X)
    return ay, bx
