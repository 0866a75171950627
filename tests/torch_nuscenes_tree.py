"""A miniature nuScenes-format dataset for the port's tests.

The tree of ``tests/test_nuscenes.py`` (one scene, CAM_FRONT and
LIDAR_TOP, identity calibrations, the ego moving 1 m a frame at 12 Hz,
four LiDAR points at known depths), with ``n_frames`` camera frames
saved as ``.npy`` RGB files (so a render job reads them without an
image codec), one LiDAR sweep per frame, and ``n_random`` more points in
front of the camera, the first ``n_random // 5`` of them repeated 1.5x
farther along the same ray so that the z-buffer sees pixels hit twice.
Imports neither jax nor the JAX package.
"""

import json
import os

import numpy as np

INTRINSIC = [[800.0, 0.0, 800.0], [0.0, 800.0, 450.0], [0.0, 0.0, 1.0]]
IDENT = [1.0, 0.0, 0.0, 0.0]


def _write(path, rows):
    with open(path, "w") as fh:
        json.dump(rows, fh)


def frame_name(i: int) -> str:
    return f"frame{i}"


def write_tree(root: str, n_frames: int = 3, frame_hw=(90, 160),
               n_random: int = 3000, seed: int = 0) -> str:
    """Write the tree under ``root`` (created); returns ``root``."""
    rng = np.random.RandomState(seed)
    vdir = os.path.join(root, "v1.0-trainval")
    cams = os.path.join(root, "samples", "CAM_FRONT")
    sweeps = os.path.join(root, "sweeps", "LIDAR_TOP")
    for d in (vdir, cams, sweeps):
        os.makedirs(d)

    _write(os.path.join(vdir, "sensor.json"), [
        {"token": "sens_cam", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "sens_lidar", "channel": "LIDAR_TOP",
         "modality": "lidar"},
    ])
    _write(os.path.join(vdir, "calibrated_sensor.json"), [
        {"token": "cs_cam", "sensor_token": "sens_cam",
         "translation": [0.0, 0.0, 0.0], "rotation": IDENT,
         "camera_intrinsic": INTRINSIC},
        {"token": "cs_lidar", "sensor_token": "sens_lidar",
         "translation": [0.0, 0.0, 0.0], "rotation": IDENT,
         "camera_intrinsic": []},
    ])
    # Ego moves 1 m in x between frames at 12 Hz -> 43.2 km/h.
    _write(os.path.join(vdir, "ego_pose.json"), [
        {"token": f"pose{i}", "translation": [float(i), 0.0, 0.0],
         "rotation": IDENT} for i in range(n_frames)])
    _write(os.path.join(vdir, "scene.json"), [
        {"token": "scene0", "first_sample_token": "sample0",
         "name": "scene-0001"}])
    _write(os.path.join(vdir, "sample.json"), [
        {"token": f"sample{i}", "scene_token": "scene0",
         "data": {"CAM_FRONT": f"sd_cam{i}", "LIDAR_TOP": f"sd_lidar{i}"}}
        for i in range(n_frames)])
    rows = []
    for i in range(n_frames):
        rows.append({
            "token": f"sd_cam{i}", "sample_token": f"sample{i}",
            "calibrated_sensor_token": "cs_cam", "ego_pose_token": f"pose{i}",
            "filename": f"samples/CAM_FRONT/{frame_name(i)}.npy",
            "is_key_frame": True,
            "next": f"sd_cam{i + 1}" if i + 1 < n_frames else ""})
        rows.append({
            "token": f"sd_lidar{i}", "sample_token": f"sample{i}",
            "calibrated_sensor_token": "cs_lidar",
            "ego_pose_token": f"pose{i}",
            "filename": f"sweeps/LIDAR_TOP/scan{i}.pcd.bin",
            "is_key_frame": True, "next": ""})
    _write(os.path.join(vdir, "sample_data.json"), rows)

    h, w = frame_hw
    for i in range(n_frames):
        np.save(os.path.join(cams, frame_name(i) + ".npy"),
                (rng.rand(h, w, 3) * 255).astype(np.uint8))
        known = np.zeros((4, 3), np.float32)
        known[:, 0] = [0.0, 2.0, -3.0, 0.5]       # x (lateral)
        known[:, 1] = [0.2, -1.0, 0.5, 0.0]       # y
        known[:, 2] = [10.0, 20.0, 15.0, 0.5]     # z = depth
        pts = np.stack([rng.uniform(-20, 20, n_random),
                        rng.uniform(-10, 10, n_random),
                        rng.uniform(0.5, 60.0, n_random)], -1)
        again = pts[:n_random // 5] * 1.5
        xyz = np.concatenate([known, pts, again]).astype(np.float32)
        scan = np.zeros((len(xyz), 5), np.float32)
        scan[:, :3] = xyz
        scan.tofile(os.path.join(sweeps, f"scan{i}.pcd.bin"))
    return root
