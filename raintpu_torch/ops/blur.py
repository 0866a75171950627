"""Fixed-kernel separable Gaussian blur with REFLECT_101 borders.

Counterpart of the dense path of ``raintpu.ops.blur``: the
``cv2.GaussianBlur(img, (K, K), sigma)`` semantics of the reference's
fog pass and envmap feather — a truncated kernel of fixed width K and
REFLECT_101 borders — as one dense (n, n) band-matrix product per axis.
The products are plain ``torch.matmul`` (the JAX package leaves them
to XLA, outside any Pallas kernel); callers keep TF32 off so they are
exact float32.

Axes of ``_BLOCKED_BLUR_MIN_DIM`` or more, where the JAX package
switches to block slabs, raise NotImplementedError here: no axis of the
KITTI paths reaches it, and on a CUDA card the fog's stencil kernel
(:mod:`raintpu_torch.ops.blur_kernel`) takes any axis length.

:func:`variable_separable_blur` is the golden render path's per-drop
defocus (``texture_mode="gather"``): every patch its own Gaussian,
zero-padded, as two per-item band-matrix products.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCKED_BLUR_MIN_DIM = 3073

_blur_matrix_cache = {}
_blur_tensor_cache = {}


def cv2_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """1-D Gaussian kernel identical to ``cv2.getGaussianKernel``
    (sigma > 0 required)."""
    assert sigma > 0 and ksize % 2 == 1
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _blur_matrix(n: int, kernel_key, kernel: np.ndarray) -> np.ndarray:
    """(n, n) float32 band matrix applying the 1-D kernel with
    REFLECT_101 borders: out = K @ x."""
    key = (n, kernel_key)
    if key in _blur_matrix_cache:
        return _blur_matrix_cache[key]
    r = (kernel.shape[0] - 1) // 2
    K = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for k, wgt in enumerate(kernel):
        j = i - r + k
        # REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ... — the
        # reflection group has period 2(n-1), so fold exactly: r >= n
        # reflects more than once (tiny envmaps under the 15-tap
        # feather).
        if n == 1:
            j = np.zeros_like(j)
        else:
            p = 2 * (n - 1)
            j = np.abs(j) % p
            j = np.where(j >= n, p - j, j)
        np.add.at(K, (i, j), wgt)
    _blur_matrix_cache[key] = K
    return K


def _blur_tensor(n: int, kernel_key, kernel: np.ndarray,
                 device) -> torch.Tensor:
    key = (n, kernel_key, str(device))
    if key not in _blur_tensor_cache:
        _blur_tensor_cache[key] = torch.as_tensor(
            _blur_matrix(n, kernel_key, kernel), device=device)
    return _blur_tensor_cache[key]


def _dense_axis_blur(x: torch.Tensor, kernel_key, kernel: np.ndarray,
                     axis: int) -> torch.Tensor:
    """Dense (n, n) band-matrix blur of ``axis`` (-1 or -2)."""
    n = x.shape[axis]
    r = (kernel.shape[0] - 1) // 2
    if n >= _BLOCKED_BLUR_MIN_DIM and r < n:
        raise NotImplementedError(
            f"blur axis of {n} >= {_BLOCKED_BLUR_MIN_DIM}: the block-slab "
            "blur for wide axes is not ported")
    K = _blur_tensor(n, kernel_key, kernel, x.device)
    if axis == -1:
        return torch.matmul(x, K.T)
    return torch.matmul(K, x)


def separable_blur_hw(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of the last two axes of (..., H, W) with one
    static 1-D kernel, REFLECT_101 borders (cv2 default)."""
    ksize = kernel.shape[0]
    kernel_key = (ksize, float(kernel[0]), float(kernel[ksize // 2]))
    out = _dense_axis_blur(x, kernel_key, kernel, -2)
    return _dense_axis_blur(out, kernel_key, kernel, -1)


def separable_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable blur of (H, W) or channels-last (..., H, W, C),
    REFLECT_101 borders."""
    if img.ndim == 2:
        return separable_blur_hw(img, kernel)
    return torch.movedim(
        separable_blur_hw(torch.movedim(img, -1, -3), kernel), -3, -1)


def _band_matrix(sigma: torch.Tensor, size: int, radius: int) -> torch.Tensor:
    """Per-item Gaussian band matrix (N, size, size).

    Row i holds the scipy-compatible taps centered at i: truncated at
    min(radius, floor(4*sigma + 0.5)), normalized by the FULL kernel
    mass, so border rows lose mass exactly as a zero-padded convolution
    does.
    """
    sigma = torch.clamp_min(sigma, 1e-6)
    idx = torch.arange(size, dtype=torch.float32, device=sigma.device)
    d = idx[None, :] - idx[:, None]                     # (size, size) k - i
    item_radius = torch.clamp_max(torch.floor(4.0 * sigma + 0.5),
                                  float(radius))
    s2 = 2.0 * sigma[:, None, None] ** 2
    w = torch.exp(-(d[None] ** 2) / s2)
    w = torch.where(torch.abs(d)[None] <= item_radius[:, None, None], w, 0.0)
    # Full-kernel normalizer (independent of position): the sum over
    # taps |k| <= item_radius of exp(-k^2 / 2 sigma^2).
    k = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    full = torch.exp(-(k[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    full = torch.where(torch.abs(k)[None, :] <= item_radius[:, None], full,
                       0.0)
    return w / full.sum(-1)[:, None, None]


def variable_separable_blur(patches: torch.Tensor,
                            sigma_rows: torch.Tensor,
                            sigma_cols: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Blur a batch of patches, each with its own (row, col) sigmas.

    patches: (N, H, W); sigma_rows/sigma_cols: (N,). ``radius`` is the
    static largest kernel radius: a sigma above radius/4 keeps its
    width but its taps stop at ``radius``. Zero padding: drop patches
    carry a zero margin at least as wide as the blur support, so the
    border cannot reach their content. Two per-item band products
    (``torch.bmm``) in float32; callers keep TF32 off.
    """
    _, h, w = patches.shape
    out = torch.bmm(_band_matrix(sigma_rows, h, radius), patches)
    wc = _band_matrix(sigma_cols, w, radius)             # (N, W, W)
    return torch.bmm(out, wc.transpose(1, 2))
