"""Depth-map smoothing preprocessor (reference ``scripts/smooth_depth.py``).

The port's copy of ``raintpu.tools.smooth_depth``, in PyTorch on the
tensors' device. Estimated or LiDAR-projected depth maps are noisy and
the renderer's fog pass amplifies high-frequency depth noise, so each
map is Gaussian-smoothed ((7, 7), sigma 1, REFLECT_101 — the reference's
``cv2.GaussianBlur``); optionally, textureless far-field patches are
pushed to a 300 m far plane first. The Gaussian is an odd separable
filter with REFLECT_101 borders, the function of the fog's stencil
blur: on a CUDA tensor it launches that kernel
(:func:`raintpu_torch.ops.blur_kernel.separable_blur`, 7 taps), on a
CPU tensor it runs the kernel's plain version. Saves ``.npy`` depth in
metres, which the render pipeline loads directly.

Usage:
    python -m raintpu_torch.tools.smooth_depth IMAGES DEPTH OUT
        [--threshold T] [--far_planes] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from raintpu_torch import resolve_device
from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops.blur import cv2_gaussian_kernel

FAR_PLANE_M = 300.0
GAUSS_KSIZE = 7
GAUSS_SIGMA = 1.0


def box_filter(x: torch.Tensor, window: int) -> torch.Tensor:
    """``cv2.boxFilter(x, -1, (window, window))`` of (H, W) float32: the
    normalized box, REFLECT_101 borders, anchored at window // 2 (so an
    even window takes window // 2 pixels before the centre and one fewer
    after), summed in float64."""
    lo = window // 2
    hi = window - 1 - lo
    xp = F.pad(x.to(torch.float64)[None, None], (lo, hi, lo, hi),
               mode="reflect")
    return F.avg_pool2d(xp, window, stride=1)[0, 0].to(torch.float32)


def far_plane_mask(gray: torch.Tensor, threshold: float,
                   window: int) -> torch.Tensor:
    """(H, W) bool: the pixels of every window x window patch whose
    top-left corner lies on the step grid (step window // 5) and whose
    centre pixel's local intensity std is below ``threshold`` — the
    reference's loop over patches, as a max-pool of the grid's flat
    centres over the window each one covers."""
    h, w = gray.shape[:2]
    step = max(window // 5, 1)
    g = gray.to(torch.float32)
    mean = box_filter(g, window)
    sq = box_filter(g * g, window)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
    flat = std < threshold
    dev = gray.device
    ys = torch.arange(0, max(h - window, 0), step, device=dev)
    xs = torch.arange(0, max(w - window, 0), step, device=dev)
    seeds = torch.zeros((h, w), dtype=torch.float32, device=dev)
    seeds[ys[:, None], xs[None, :]] = flat[
        (ys + window // 2)[:, None], (xs + window // 2)[None, :]].float()
    # Pixel p is covered by a patch starting at q for q in
    # [p - window + 1, p] on both axes.
    covered = F.max_pool2d(
        F.pad(seeds[None, None], (window - 1, 0, window - 1, 0)), window,
        stride=1)[0, 0]
    return covered > 0


def improve_depth(gray: torch.Tensor, depth: torch.Tensor,
                  threshold: float = 0.001,
                  threshold_faraway_planes: bool = False,
                  window: int = 20) -> torch.Tensor:
    """Smooth one (H, W) depth map; optionally far-plane flat patches.

    A patch whose image-intensity std is below ``threshold`` carries no
    texture — for offline-estimated depth that usually means no valid
    measurement (too far); those windows are set to the far plane.
    ``gray`` (H, W) intensities and ``depth`` lie on one device."""
    depth = depth.to(torch.float32)
    if threshold_faraway_planes:
        depth = torch.where(far_plane_mask(gray, threshold, window),
                            torch.full_like(depth, FAR_PLANE_M), depth)
    taps = cv2_gaussian_kernel(GAUSS_KSIZE, GAUSS_SIGMA)
    return blur_kernel.separable_blur(depth[None].contiguous(), taps)[0]


def process_all(images_path: str, depth_path: str, output_path: str,
                threshold: float = 0.0,
                threshold_faraway_planes: bool = False,
                device=None) -> int:
    """Smooth every 16-bit depth PNG (metres * 256) of ``depth_path``,
    paired in natural order with the images of ``images_path``, on
    ``device`` (None: the CUDA card); writes OUT/IMAGE_NAME.npy."""
    from PIL import Image

    from raintpu_torch.utils.logging import natural_listdir, progress_bar

    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    img_names = natural_listdir(images_path)
    depth_names = natural_listdir(depth_path)
    for i, (img_f, dep_f) in enumerate(zip(img_names, depth_names)):
        progress_bar(i + 1, len(img_names))
        with Image.open(os.path.join(images_path, img_f)) as im:
            gray = np.array(im.convert("L"))
        with Image.open(os.path.join(depth_path, dep_f)) as im:
            depth16 = np.array(im)
        depth = depth16.astype(np.float32) / 256.0  # meters
        smooth = improve_depth(torch.as_tensor(gray, device=dev),
                               torch.as_tensor(depth, device=dev),
                               threshold, threshold_faraway_planes)
        np.save(os.path.join(output_path, img_f), smooth.cpu().numpy())
    return len(img_names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("images")
    ap.add_argument("depth")
    ap.add_argument("output")
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--far_planes", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    n = process_all(args.images, args.depth, args.output,
                    args.threshold, args.far_planes, args.device)
    print(f"\nProcessed {n} depth maps -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
