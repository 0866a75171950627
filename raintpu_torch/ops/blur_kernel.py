"""Separable stencil blur of (N, H, W) planes: the fog stage's kernel.

Counterpart of ``raintpu.ops.pallas.blur_kernel.separable_blur_pallas``:
both axes of one odd-length 1-D filter over a stack of float32 planes,
REFLECT_101 borders (the cv2 default), H axis first. On CUDA tensors
:func:`separable_blur` launches the hand-written kernel in
``raintpu_torch/csrc/separable_blur.cu`` (one pass, the tile and its
halo in shared memory; any radius, reflections folded as often as
needed). On CPU tensors it runs the plain version,
:func:`raintpu_torch.ops.blur.separable_blur_hw` (dense band-matrix
products), which keeps that function's refusal of axes of 3073 or more.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raintpu_torch.ops.blur import separable_blur_hw

MAX_TAPS = 129
# The kernel's grid puts the planes on its z axis.
MAX_PLANES = 65535

_taps_cache = {}


def _check(x: torch.Tensor, taps: np.ndarray) -> None:
    checks = [
        (x.ndim == 3, "x must be (N, H, W)"),
        (x.dtype == torch.float32, "x must be float32"),
        (x.is_contiguous(), "x must be contiguous"),
        (x.shape[0] <= MAX_PLANES, f"at most {MAX_PLANES} planes"),
        (taps.ndim == 1 and taps.shape[0] % 2 == 1,
         "taps must be one odd-length axis"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"separable_blur: {msg}")
    if taps.shape[0] > MAX_TAPS:
        raise ValueError(f"separable_blur: {taps.shape[0]} taps, the "
                         f"kernel takes at most {MAX_TAPS}")


def _device_taps(taps: np.ndarray, device) -> torch.Tensor:
    key = (str(device), taps.tobytes())
    if key not in _taps_cache:
        _taps_cache[key] = torch.as_tensor(taps, device=device)
    return _taps_cache[key]


def _kernel_fn():
    from raintpu_torch import cuda_build

    lib = cuda_build.load("separable_blur")
    fn = lib.separable_blur_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.separable_blur_error_string.argtypes = [ctypes.c_int]
        lib.separable_blur_error_string.restype = ctypes.c_char_p
    return lib, fn


def separable_blur(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Blur both axes of (N, H, W) float32 planes with the odd-length
    1-D ``taps`` (at most 129), REFLECT_101 borders: the CUDA kernel
    (one launch, on the current stream, no synchronisation) for CUDA
    tensors, the plain version for CPU tensors.
    ``separable_blur.launches`` counts kernel launches."""
    taps = np.asarray(taps, np.float32)
    _check(x, taps)
    if x.device.type == "cpu":
        return separable_blur_hw(x, taps)
    if x.device.type != "cuda":
        raise ValueError(f"separable_blur: no kernel for {x.device.type}")
    out = torch.empty_like(x)
    n, h, w = x.shape
    lib, fn = _kernel_fn()
    dev_taps = _device_taps(taps, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dev_taps.data_ptr(), out.data_ptr(), n, h, w,
                 (taps.shape[0] - 1) // 2, stream)
    if err != 0:
        raise RuntimeError("separable_blur kernel launch failed: "
                           + lib.separable_blur_error_string(err).decode())
    separable_blur.launches += 1
    return out


separable_blur.launches = 0
