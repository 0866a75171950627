"""Fixed-kernel separable Gaussian blur, REFLECT_101 borders, as plain
band-matrix products (``cv2.GaussianBlur`` semantics): one axis at a
time, H then W; an axis of 3073 px or more is cut into overlapping
block slabs multiplied by one band. Float32 matmuls with TF32 off."""

from __future__ import annotations

import numpy as np
import torch

BLOCKED_MIN_DIM = 3073


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)``, float32."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _dense_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """(n, n) band matrix of ``kernel`` with REFLECT_101 borders."""
    r = (kernel.shape[0] - 1) // 2
    out = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for k, wgt in enumerate(kernel):
        j = i - r + k
        if n == 1:
            j = np.zeros_like(j)
        else:
            p = 2 * (n - 1)
            j = np.abs(j) % p
            j = np.where(j >= n, p - j, j)
        np.add.at(out, (i, j), wgt)
    return out


def _block_matrix(kernel: np.ndarray, block: int) -> np.ndarray:
    """(block + 2r, block): column o holds the taps of output o of a
    slab that starts r inputs before output 0."""
    out = np.zeros((block + kernel.shape[0] - 1, block), np.float32)
    for t, wgt in enumerate(kernel):
        out[np.arange(block) + t, np.arange(block)] = wgt
    return out


def _axis_blur(x: torch.Tensor, kernel: np.ndarray, axis: int):
    n = x.shape[axis]
    r = (kernel.shape[0] - 1) // 2
    if n < BLOCKED_MIN_DIM or r >= n:
        k = torch.as_tensor(_dense_matrix(n, kernel), device=x.device)
        return torch.matmul(x, k.T) if axis == -1 else torch.matmul(k, x)
    depth = -(-(2 * r + 1) // 128) * 128
    block = depth - 2 * r
    nb = -(-n // block)
    ax = x.ndim + axis
    top = x.narrow(ax, 1, r).flip(ax)
    bot = x.narrow(ax, n - r - 1, r).flip(ax)
    zshape = list(x.shape)
    zshape[ax] = nb * block - n
    xp = torch.cat([top, x, bot, x.new_zeros(zshape)], dim=ax)
    slabs = xp.unfold(ax, depth, block)
    b = torch.as_tensor(_block_matrix(kernel, block), device=x.device)
    if axis == -1:
        return torch.matmul(slabs, b).flatten(-2)[..., :n]
    out = torch.matmul(b.T, slabs.transpose(-1, -2))
    return out.flatten(-3, -2)[..., :n, :]


def blur_hw(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Blur the last two axes of (..., H, W)."""
    return _axis_blur(_axis_blur(x, kernel, -2), kernel, -1)


def blur_channels_last(img: torch.Tensor, kernel: np.ndarray):
    """Blur the (H, W) axes of (..., H, W, C)."""
    return torch.movedim(blur_hw(torch.movedim(img, -1, -3), kernel), -3, -1)
