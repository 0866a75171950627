"""nuScenes data access — self-contained (no nuscenes-devkit needed).

The port's copy of ``raintpu.data.nuscenes_data`` (the reference's
``config/nuscenes/nusc_dataset.py``). The five tables the renderer needs
(scene, sample, sample_data, ego_pose, calibrated_sensor) are read
directly from ``v1.0-*/*.json`` and LiDAR sweeps from the plain float32
``.pcd.bin`` layout.

Everything up to the LiDAR projection is numpy host code, unchanged:
token selection, scene chains, camera settings, ego speeds, scene
durations, and the five-step projection in float64. The dense depth
map is PyTorch on ``device`` (the CUDA card unless the caller asks for
the CPU): a z-buffer by ``scatter_reduce(..., "amin")`` — the nearest
point wins, as the JAX package's write of the nearest point last gives,
and without the undefined order of duplicate index writes on CUDA —
then the (2·dilate + 1)² min filter as a max-pool of the negated map,
which is ``cv2.erode``'s result with its default border.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from raintpu_torch import resolve_device

# CCD facts (https://www.nuscenes.org/data-collection; reference :132-146)
CCD_WH = (1600, 1200)
PX_SIZE_UM = 1.98
EXPOSURE_MS = 20.0
CAM_HZ = 12.0
IMAGE_WH = (1600, 900)
# Depth written where no LiDAR point reaches (sky).
FAR_PLANE_M = 300.0


def quat_rotmat(q) -> np.ndarray:
    """Rotation matrix from quaternion (w, x, y, z)."""
    w, x, y, z = np.asarray(q, float)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


class NuScenesTables:
    """Minimal nuScenes metadata DB: token-indexed JSON tables."""

    TABLES = ("scene", "sample", "sample_data", "ego_pose",
              "calibrated_sensor", "sensor")

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        if not os.path.isdir(table_dir):
            raise FileNotFoundError(
                f"nuScenes metadata not found at {table_dir}")
        self._tables: Dict[str, Dict[str, dict]] = {}
        for name in self.TABLES:
            with open(os.path.join(table_dir, name + ".json")) as fh:
                rows = json.load(fh)
            self._tables[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    def rows(self, table: str) -> List[dict]:
        return list(self._tables[table].values())


class NuScenesCameraData:
    """Scene-oriented access for one camera sensor (+ LiDAR for depth)."""

    def __init__(self, dataroot: str, version: str = "v1.0-trainval",
                 sensor: str = "CAM_FRONT", lidar: str = "LIDAR_TOP",
                 specific_tokens: Optional[List[str]] = None,
                 only_annotated: bool = False):
        self.db = NuScenesTables(dataroot, version)
        self.sensor = sensor
        self.lidar = lidar
        self.only_annotated = only_annotated
        self.specific_tokens = set(specific_tokens or [])

        # All camera sample_data tokens of this sensor (+ split filter).
        sensor_tokens = {t for t, r in self.db._tables["sensor"].items()
                         if r["channel"] == sensor}
        calib_by_sensor = {
            t for t, r in self.db._tables["calibrated_sensor"].items()
            if r["sensor_token"] in sensor_tokens}
        self.tokens = []
        for t, sd in self.db._tables["sample_data"].items():
            if sd["calibrated_sensor_token"] not in calib_by_sensor:
                continue
            if self.specific_tokens and t not in self.specific_tokens:
                continue
            if only_annotated and not sd["is_key_frame"]:
                continue
            self.tokens.append(t)

        self.scene_tokens = sorted(
            {self.scene_of(t) for t in self.tokens})

    def scene_of(self, sample_data_token: str) -> str:
        sd = self.db.get("sample_data", sample_data_token)
        sample = self.db.get("sample", sd["sample_token"])
        return sample["scene_token"]

    def _first_sd_token(self, scene_token: str) -> str:
        scene = self.db.get("scene", scene_token)
        sample = self.db.get("sample", scene["first_sample_token"])
        return sample["data"][self.sensor]

    def _chain(self, scene_token: str) -> List[str]:
        out = []
        tok = self._first_sd_token(scene_token)
        while tok:
            out.append(tok)
            tok = self.db.get("sample_data", tok)["next"]
        return out

    def get_filepaths(self, scene_token: str) -> List[str]:
        """Ordered relative file paths of the scene's camera frames."""
        use_specific = bool(self.specific_tokens)
        out = []
        for tok in self._chain(scene_token):
            sd = self.db.get("sample_data", tok)
            if use_specific and tok not in self.specific_tokens:
                continue
            if self.only_annotated and not sd["is_key_frame"]:
                continue
            out.append(sd["filename"])
        return out

    def camera_settings(self, scene_token: str) -> dict:
        """Per-scene camera settings from intrinsics + CCD facts."""
        sd = self.db.get("sample_data", self._first_sd_token(scene_token))
        cs = self.db.get("calibrated_sensor", sd["calibrated_sensor_token"])
        intr = np.asarray(cs["camera_intrinsic"], float)
        focal_mm = float(np.mean([intr[0, 0], intr[1, 1]])
                         * PX_SIZE_UM / 1000.0)
        return {
            "translation": cs["translation"], "focal": focal_mm,
            "px_size": PX_SIZE_UM, "ccd_width": CCD_WH[0],
            "ccd_height": CCD_WH[1], "width": IMAGE_WH[0],
            "height": IMAGE_WH[1], "frequency": CAM_HZ,
            "exposure": EXPOSURE_MS,
        }

    def camera_motions(self, scene_token: str) -> List[float]:
        """Per-frame camera speeds (km/h) from ego_pose displacement at
        the camera frequency (the last frame keeps its momentum)."""
        speeds = []
        last = None
        for tok in self._chain(scene_token):
            sd = self.db.get("sample_data", tok)
            pos = np.asarray(
                self.db.get("ego_pose", sd["ego_pose_token"])["translation"])
            if last is not None:
                speeds.append(float(np.linalg.norm(pos - last))
                              * CAM_HZ * 3.6)
            last = pos
        if speeds:
            speeds.append(speeds[-1])
        return speeds

    def scene_duration(self, scene_token: str, epsilon: float = 1e-3
                       ) -> float:
        return len(self._chain(scene_token)) / CAM_HZ + epsilon

    # -- depth ------------------------------------------------------------
    def load_lidar_points(self, lidar_sd: dict) -> np.ndarray:
        """(N, 3) points in the LiDAR frame (.pcd.bin: 5 float32/row)."""
        path = os.path.join(self.db.dataroot, lidar_sd["filename"])
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
        return scan[:, :3].astype(np.float64)

    def project_lidar_depth(self, sample_data_token: str,
                            min_dist: float = 1.0):
        """LiDAR points projected to the camera image.

        Returns (uv (N, 2), depth (N,)), float64: lidar -> ego(t_lidar)
        -> global -> ego(t_cam) -> camera, then intrinsics."""
        cam_sd = self.db.get("sample_data", sample_data_token)
        sample = self.db.get("sample", cam_sd["sample_token"])
        lidar_sd = self.db.get("sample_data", sample["data"][self.lidar])

        pts = self.load_lidar_points(lidar_sd).T            # (3, N)

        cs = self.db.get("calibrated_sensor",
                         lidar_sd["calibrated_sensor_token"])
        pts = quat_rotmat(cs["rotation"]) @ pts
        pts += np.asarray(cs["translation"])[:, None]

        pose = self.db.get("ego_pose", lidar_sd["ego_pose_token"])
        pts = quat_rotmat(pose["rotation"]) @ pts
        pts += np.asarray(pose["translation"])[:, None]

        pose = self.db.get("ego_pose", cam_sd["ego_pose_token"])
        pts -= np.asarray(pose["translation"])[:, None]
        pts = quat_rotmat(pose["rotation"]).T @ pts

        cs = self.db.get("calibrated_sensor",
                         cam_sd["calibrated_sensor_token"])
        pts -= np.asarray(cs["translation"])[:, None]
        pts = quat_rotmat(cs["rotation"]).T @ pts

        depths = pts[2]
        intr = np.asarray(cs["camera_intrinsic"], float)
        uvw = intr @ pts
        uv = uvw[:2] / np.maximum(uvw[2:3], 1e-9)

        w, h = IMAGE_WH
        keep = ((depths > min_dist)
                & (uv[0] > 1) & (uv[0] < w - 1)
                & (uv[1] > 1) & (uv[1] < h - 1))
        return uv[:, keep].T, depths[keep]

    def dense_depth_map(self, sample_data_token: str, dilate: int = 3,
                        device=None) -> torch.Tensor:
        """Sparse LiDAR projection -> dense (H, W) float32 depth (m) on
        ``device``.

        Nearest-depth z-buffering of the projected points, then a
        min-filter dilation into the empty pixels and the far plane
        everywhere still empty, so the fog pass gets a value
        everywhere."""
        dev = resolve_device(device)
        uv, dep = self.project_lidar_depth(sample_data_token)
        w, h = IMAGE_WH
        ui = np.clip(uv[:, 0].astype(int), 0, w - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, h - 1)
        depth = torch.full((h * w,), float("inf"), dtype=torch.float32,
                           device=dev)
        depth.scatter_reduce_(
            0, torch.as_tensor(vi * w + ui, device=dev),
            torch.as_tensor(dep.astype(np.float32), device=dev), "amin")
        depth = depth.view(h, w)

        if dilate > 1:
            finite = torch.isfinite(depth)
            filled = torch.where(finite, depth, torch.full_like(depth, 1e9))
            k = 2 * dilate + 1
            eroded = -F.max_pool2d(-filled[None, None], k, stride=1,
                                   padding=dilate)[0, 0]
            depth = torch.where(finite, depth, eroded)
        far = ~torch.isfinite(depth) | (depth >= 1e9)
        return torch.where(far, torch.full_like(depth, FAR_PLANE_M), depth)


class NuScenesGANCameraData(NuScenesCameraData):
    """GAN-translated variant: image paths are redirected to the GAN
    output tree with a filename postfix (reference :286-327)."""

    def __init__(self, dataroot: str, gan_root: str, post_fix: str = "",
                 **kw):
        super().__init__(dataroot, **kw)
        self.gan_root = gan_root
        self.post_fix = post_fix

    def get_filepaths(self, scene_token: str) -> List[str]:
        out = []
        for rel in super().get_filepaths(scene_token):
            base, _ext = os.path.splitext(os.path.basename(rel))
            name = base + (("_" + self.post_fix) if self.post_fix else "")
            out.append(os.path.join(os.path.dirname(rel), name + ".png"))
        return out
