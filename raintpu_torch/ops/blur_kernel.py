"""Separable stencil blur of (N, H, W) planes: the fog stage's kernel.

Counterpart of ``raintpu.ops.pallas.blur_kernel.separable_blur_pallas``:
both axes of one odd-length 1-D filter over a stack of float32 planes,
REFLECT_101 borders (the cv2 default), H axis first. On CUDA tensors
:func:`separable_blur` launches the hand-written kernel in
``raintpu_torch/csrc/separable_blur.cu`` (one pass, the tile and its
halo in shared memory, the next tile's input loading while this one's
sums run, runs of 8 outputs a thread in registers; any radius,
reflections folded as often as needed) with the tiling of
:func:`blur_plan`. On CPU tensors it runs the plain version,
:func:`raintpu_torch.ops.blur.separable_blur_hw` (band-matrix products:
dense below 3073 px an axis, block slabs above).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from raintpu_torch.ops.blur import separable_blur_hw

MAX_TAPS = 129
MAX_PLANES = 65535
# The kernel numbers the tiles of all planes with one int.
MAX_TILES = 2 ** 31 - 1
# Outputs a thread sums per item in each pass; tile sides are multiples.
RUN = 8
# The tile (rows, columns) a block takes, shrunk for small planes and
# for radii whose halo would not fit the shared memory.
TILE_HW = (32, 128)
# Dynamic shared memory a block of the H100 may have (227 KB).
MAX_SMEM_BYTES = 232448

_taps_cache = {}


@dataclasses.dataclass(frozen=True)
class BlurPlan:
    """The kernel's launch plan: tiles of tile_h x tile_w, ``tiles``
    (along W, along H, planes) of them, which the kernel's resident
    blocks walk in that order (W fastest)."""

    tile_h: int
    tile_w: int
    tiles: Tuple[int, int, int]
    smem_bytes: int


def blur_smem_bytes(radius: int, tile_h: int, tile_w: int) -> int:
    """Shared memory of one block, as the kernel lays it out: the taps,
    two buffers of the tile with its halo (one filling while the other
    is summed), the column-major intermediate and the output staging
    tile, both with odd pitches."""
    in_h, in_w = tile_h + 2 * radius, tile_w + 2 * radius
    floats = (2 * radius + 1 + 2 * in_h * in_w + in_w * (tile_h + 1)
              + tile_h * (tile_w + 1))
    return 4 * floats


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def blur_plan(n: int, h: int, w: int, radius: int) -> BlurPlan:
    """Launch plan for n planes of (h, w) and 2·radius + 1 taps: the
    TILE_HW tile, cut to the plane (in multiples of RUN), with its
    columns and then its rows halved until the block's shared memory
    fits."""
    tile_h = min(TILE_HW[0], _round_up(h, RUN))
    tile_w = min(TILE_HW[1], _round_up(w, RUN))
    while blur_smem_bytes(radius, tile_h, tile_w) > MAX_SMEM_BYTES:
        if tile_w >= tile_h and tile_w > RUN:
            tile_w = max(RUN, tile_w // 2 // RUN * RUN)
        elif tile_h > RUN:
            tile_h = max(RUN, tile_h // 2 // RUN * RUN)
        else:
            raise ValueError(f"separable_blur: radius {radius} does not "
                             "fit the shared memory")
    tiles = (-(-w // tile_w), -(-h // tile_h), n)
    if tiles[0] * tiles[1] * n > MAX_TILES:
        raise ValueError(f"separable_blur: {tiles} tiles exceed the "
                         f"kernel's limit of {MAX_TILES}")
    return BlurPlan(tile_h, tile_w, tiles,
                    blur_smem_bytes(radius, tile_h, tile_w))


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong, ctypes.c_void_p])
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
    taps = np.ascontiguousarray(taps, np.float32)
    _check(x, taps)
    if x.device.type == "cpu":
        return separable_blur_hw(x, taps)
    if x.device.type != "cuda":
        raise ValueError(f"separable_blur: no kernel for {x.device.type}")
    out = torch.empty_like(x)
    n, h, w = x.shape
    radius = (taps.shape[0] - 1) // 2
    plan = blur_plan(n, h, w, radius)
    lib, fn = _kernel_fn()
    dev_taps = _device_taps(taps, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dev_taps.data_ptr(), taps.ctypes.data,
                 out.data_ptr(), n, h, w, radius, plan.tile_h, plan.tile_w,
                 plan.tiles[0], plan.tiles[1], plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError("separable_blur kernel launch failed: "
                           + lib.separable_blur_error_string(err).decode())
    separable_blur.launches += 1
    return out


separable_blur.launches = 0
