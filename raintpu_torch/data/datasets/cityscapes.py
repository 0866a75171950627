"""Cityscapes dataset plugin (reference ``config/cityscapes.py``; the
port's copy of ``raintpu.data.datasets.cityscapes``).

Any folder under the dataset root containing PNGs is a sequence unless
it is a depth folder. Depth is assumed at half the RGB resolution
(depth_scale=2) and rendering happens at half size (render_scale=2).
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _find_sequences(images_root: str):
    seqs = []
    for cur, _dirs, _files in os.walk(images_root):
        rel = cur[len(images_root) + 1:]
        if not rel:
            continue
        has_png = len(glob.glob(os.path.join(cur, "*.png"))) > 0
        is_depth = "depth" in rel.split(os.sep)[-2:]
        if has_png and not is_depth:
            seqs.append(rel)
    return sorted(seqs)


def resolve_paths(params):
    params.sequences = np.asarray(_find_sequences(params.images_root))
    if len(params.sequences) == 0:
        raise FileNotFoundError(
            "No valid Cityscapes sequences under the dataset root — has "
            "the original folder structure been altered?")

    params.images = {s: os.path.join(params.images_root, s)
                     for s in params.sequences}
    params.depth = {
        s: os.path.join(params.depth_root, s, os.pardir, "depth",
                        s.split(os.sep)[-1])
        for s in params.sequences}
    # Camera intrinsic calibration not provided; small impact.
    params.calib = {s: None for s in params.sequences}
    return params


def settings():
    return {
        "cam_hz": 10,
        "cam_CCD_WH": [2040, 1016],
        "cam_CCD_pixsize": 2.2,
        "cam_WH": [2040, 1016],
        "cam_focal": 6,
        "cam_gain": 20,
        "cam_f_number": 6.0,
        "cam_focus_plane": 6.0,
        "cam_exposure": 5.0,
        "depth_scale": 2,    # depth at half RGB resolution
        "render_scale": 2,   # render at half size (Cityscapes is large)
        "cam_pos": [1.5, 1.5, 0.3],
        "cam_lookat": [1.5, 1.5, -1.0],
        "cam_up": [0.0, 1.0, 0.0],
        "sequences": {
            # European city speeds: 50..0 km/h ramp.
            "leftImg8bit": {
                "sim_mode": "steps",
                "sim_steps": {"cam_motion": np.arange(50.0, -1.0, -1.0)},
            },
        },
    }
