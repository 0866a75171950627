"""Calibrated camera geometry: KITTI calib parsing + depth back-projection.

The port's copy of ``raintpu.render.geometry`` (the reference's dormant
depth-weighting geometry, ``common/drop_depth_map.py`` /
``common/depth_drop.py``): parse KITTI ``calib_cam_to_cam.txt``
rectified projection matrices and back-project a depth map to
camera-frame 3-D points. Calibration is numpy host code; the maps are
PyTorch on the inputs' device, with the projection's pseudo-inverse
taken in float64 on the host and cast to float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CAMERA_HEIGHT_M = 1.65  # KITTI cam0 mounting height above ground


@dataclasses.dataclass
class KittiCalib:
    p_rect: np.ndarray      # (3, 4) rectified projection (P_rect_0X)
    r_rect: np.ndarray      # (3, 3) rectifying rotation (R_rect_0X)

    @property
    def projection(self) -> np.ndarray:
        """(3, 4) combined P_rect @ [R_rect 0; 0 1]."""
        r44 = np.eye(4)
        r44[:3, :3] = self.r_rect
        return self.p_rect @ r44

    @property
    def cam_offset_x(self) -> float:
        """Lateral offset of this camera w.r.t. cam0 (meters)."""
        return float(self.p_rect[0, 3] / (-self.p_rect[0, 0]))


def parse_kitti_calib(path: str, camera: int = 2) -> KittiCalib:
    """Read P_rect_0N / R_rect_0N from a calib_cam_to_cam.txt file."""
    p_rect = r_rect = None
    with open(path) as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            vals = rest.split()
            if key == f"P_rect_{camera:02d}":
                p_rect = np.asarray(vals, float).reshape(3, 4)
            elif key == f"R_rect_{camera:02d}":
                r_rect = np.asarray(vals, float).reshape(3, 3)
    if p_rect is None or r_rect is None:
        raise ValueError(f"Missing P_rect/R_rect for cam {camera} in {path}")
    return KittiCalib(p_rect=p_rect, r_rect=r_rect)


def _pinv(projection: np.ndarray, device) -> torch.Tensor:
    """(4, 3) float32 pseudo-inverse of the projection, on ``device``."""
    return torch.as_tensor(np.linalg.pinv(projection).astype(np.float32),
                           device=device)


def backproject_depth(depth: torch.Tensor, projection: np.ndarray
                      ) -> torch.Tensor:
    """Depth (H, W) meters -> camera-frame 3-D points (H, W, 3).

    Pixel (u, v) rays come from the pseudo-inverse of the projection;
    points are scaled so their z equals the depth value, with the y axis
    flipped to the renderer's y-up convention
    (``drop_depth_map.py:80``).
    """
    h, w = depth.shape
    dev = depth.device
    pinv = _pinv(projection, dev)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], -1)        # (H, W, 3)
    rays = torch.einsum("ij,hwj->hwi", pinv, pix)[..., :3]
    rz = rays[..., 2]
    scale = depth / torch.where(rz == 0, torch.full_like(rz, 1e-9), rz)
    pts = rays * scale[..., None]
    return pts * torch.tensor([1.0, -1.0, 1.0], device=dev)


def drop_distance_map(points: torch.Tensor, drop_pos: torch.Tensor
                      ) -> torch.Tensor:
    """Distance from each back-projected scene point to each drop.

    points (H, W, 3); drop_pos (N, 3) -> (N, H, W). The per-drop
    occlusion weighting the reference intended: scene points nearer
    than the drop do not light it.
    """
    d = points[None] - drop_pos[:, None, None]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def pixel_ray_ground_intersection(u: torch.Tensor, v: torch.Tensor,
                                  projection: np.ndarray,
                                  camera_height: float = CAMERA_HEIGHT_M
                                  ) -> torch.Tensor:
    """Intersect pixel rays with the ground plane (y = -camera_height).

    The reference's unused ``depth_drop.py`` ray/ground utility, on
    tensors. u, v: (...,) pixel coords -> (..., 3) points.
    """
    pinv = _pinv(projection, u.device)
    pix = torch.stack([u, v, torch.ones_like(u)], -1)
    rays = torch.einsum("ij,...j->...i", pinv, pix)[..., :3]
    # y grows downward in the camera frame; ground at +camera_height.
    ry = rays[..., 1]
    t = camera_height / torch.where(ry == 0, torch.full_like(ry, 1e-9), ry)
    return rays * t[..., None]
