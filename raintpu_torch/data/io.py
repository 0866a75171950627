"""Host-side image/depth I/O and ordered prefetching.

The port's copy of ``raintpu.data.io``. Frames load on a thread pool
while the card renders the previous batch. ``.npy`` images and depth
maps need nothing beyond numpy; PNG/JPG decoding imports PIL, and a
``render_scale`` other than 1 or a depth map of another size imports
cv2, each only when a frame asks for it.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image as float32 RGB in [0, 1] (PNG/JPG via PIL, or .npy)."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return np.asarray(arr, np.float32)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def load_depth_m(path: str) -> Optional[np.ndarray]:
    """Load metric depth (meters): 16-bit PNG / 256 (KITTI convention)
    or .npy."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    from PIL import Image

    try:
        with Image.open(path) as im:
            arr = np.asarray(im)
    except (OSError, ValueError):
        return None  # missing/corrupted depth -> caller skips the frame
    return arr.astype(np.float32) / 256.0


def resize_area(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """The reference's cv2.resize (bilinear by default) of image and
    depth."""
    import cv2

    return cv2.resize(img, (int(wh[0]), int(wh[1])))


def crop_center(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Center crop (reference my_utils.py:88-96): when depth and RGB
    sizes mismatch, depth is assumed crop-centered."""
    y0 = int((image.shape[0] - height) / 2)
    x0 = int((image.shape[1] - width) / 2)
    return image[y0:y0 + height, x0:x0 + width]


def load_frame(image_path: str, depth_path: str,
               render_scale: int, depth_scale: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Load + scale one (image, depth) pair per the reference semantics
    (generator.py:352-381):
      image  -> size // render_scale
      depth  -> (depth_size * depth_scale) // render_scale
      mismatch -> image crop-centered to the depth size.
    Returns None if depth is missing/corrupted (frame skipped).
    """
    bg = load_image_rgb(image_path)
    if render_scale != 1:
        bg = resize_area(bg, (bg.shape[1] // render_scale,
                              bg.shape[0] // render_scale))
    depth = load_depth_m(depth_path)
    if depth is None:
        return None
    target_hw = (int(depth.shape[0] * depth_scale) // render_scale,
                 int(depth.shape[1] * depth_scale) // render_scale)
    if tuple(depth.shape[:2]) != target_hw:
        depth = resize_area(depth, (target_hw[1], target_hw[0]))
    if depth.shape[0] > bg.shape[0] or depth.shape[1] > bg.shape[1]:
        raise ValueError(
            f"Depth {depth.shape} cannot be larger than image "
            f"{bg.shape[:2]} ({image_path})")
    if tuple(depth.shape[:2]) != tuple(bg.shape[:2]):
        bg = crop_center(bg, depth.shape[0], depth.shape[1])
    return bg.astype(np.float32), depth.astype(np.float32)


def prefetch_map(fn, items: Iterable, workers: int = 4,
                 depth: int = 8) -> Iterator:
    """Ordered prefetching map over a thread pool: keeps up to ``depth``
    results in flight so host I/O overlaps device work. Yields fn(item)
    in order."""
    items = iter(items)
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        try:
            for _ in range(depth):
                pending.append(pool.submit(fn, next(items)))
        except StopIteration:
            pass
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(pool.submit(fn, next(items)))
            except StopIteration:
                pass
            yield fut.result()
