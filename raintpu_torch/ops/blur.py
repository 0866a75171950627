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
