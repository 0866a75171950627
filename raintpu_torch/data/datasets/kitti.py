"""KITTI dataset plugin (reference ``config/kitti.py``).

Sequence discovery walks the dataset root for either object-benchmark
layouts (an ``image_2`` + ``calib`` pair) or raw-data drives
(``image_02`` under a ``*_sync`` folder). Per-frame camera speeds for
the four raw drives the reference ships are loaded from
``kitti_odometry.json`` (measured GPS data); object-benchmark sequences
get the same synthetic 100->0 km/h ramp.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _find_sequences(images_root: str):
    seqs = []
    for cur, dirs, _files in os.walk(images_root):
        rel = cur[len(images_root) + 1:]
        if not rel:
            continue
        has_object = (os.path.isdir(os.path.join(cur, "image_2"))
                      and os.path.isdir(os.path.join(cur, "calib")))
        has_raw = (os.path.isdir(os.path.join(cur, "image_02"))
                   and rel.endswith("_sync"))
        if has_object or has_raw:
            seqs.append(rel)
    return sorted(seqs)


def resolve_paths(params):
    params.sequences = np.asarray(_find_sequences(params.images_root))
    if len(params.sequences) == 0:
        raise FileNotFoundError(
            "No valid KITTI sequences under the dataset root — did you "
            "download the calibration files?")

    params.images, params.calib, params.depth = {}, {}, {}
    for seq in params.sequences:
        if seq.startswith("raw_data"):
            img_dir = os.path.join(params.dataset_root, seq,
                                   "image_02", "data")
            params.images[seq] = img_dir
            params.calib[seq] = os.path.join(
                params.dataset_root, seq, os.pardir, "calib_cam_to_cam.txt")
            params.depth[seq] = os.path.join(img_dir, "depth")
        else:
            img_dir = os.path.join(params.dataset_root, seq, "image_2")
            params.images[seq] = img_dir
            calib_dir = os.path.join(params.dataset_root, seq, "calib")
            params.calib[seq] = [
                os.path.join(calib_dir, f)
                for f in sorted(os.listdir(calib_dir)) if f.endswith(".txt")]
            params.depth[seq] = os.path.join(img_dir, "depth")
    return params


def settings():
    s = {
        "cam_hz": 10,
        "cam_CCD_WH": [1242, 375],
        "cam_CCD_pixsize": 4.65,
        "cam_WH": [1242, 375],
        "cam_focal": 6,
        "cam_gain": 20,
        "cam_f_number": 6.0,
        "cam_focus_plane": 6.0,
        "cam_exposure": 2,
        "cam_pos": [1.5, 1.5, 0.3],
        "cam_lookat": [1.5, 1.5, -1.0],
        "cam_up": [0.0, 1.0, 0.0],
        "sequences": {},
    }
    # Object benchmark: no speed data -> 100..0 km/h ramp across steps.
    s["sequences"]["data_object"] = {
        "sim_mode": "steps",
        "sim_steps": {"cam_motion": np.arange(100.0, -1.0, -1.0)},
    }
    # Raw drives: measured per-frame speeds (data file).
    odo_path = os.path.join(os.path.dirname(__file__),
                            "kitti_odometry.json")
    with open(odo_path) as fh:
        drives = json.load(fh)["drives"]
    for seq, speeds in drives.items():
        s["sequences"][seq] = {
            "sim_mode": "steps",
            "sim_steps": {"cam_motion": np.asarray(speeds, np.float64)},
        }
    return s
