"""nuScenes dataset plugin (the port's copy of
``raintpu.data.datasets.nuscenes``).

Sequences are scene tokens (or scene indices on the CLI), images are
the ordered CAM_FRONT frame paths, and depth comes from LiDAR-projected
``.npy`` maps under the depth root (precompute them with
``python -m raintpu_torch.tools.nuscenes_depth``).

The dataset tables are read once per (dataset root, split file) and
kept for the process; a second root gets its own tables.
"""

from __future__ import annotations

import json
import os

from raintpu_torch.data.nuscenes_data import (CAM_HZ, CCD_WH, EXPOSURE_MS,
                                              IMAGE_WH, PX_SIZE_UM,
                                              NuScenesCameraData)

_datasets = {}


def split_tokens(json_file):
    """The split file's sample_data tokens, or None without a file."""
    if not json_file:
        return None
    with open(json_file) as fh:
        return json.load(fh)["sample_data_tokens"]


def _get_dataset(params) -> NuScenesCameraData:
    json_file = getattr(params, "json_file", None)
    key = (params.dataset_root, json_file)
    if key not in _datasets:
        _datasets[key] = NuScenesCameraData(
            dataroot=params.dataset_root,
            specific_tokens=split_tokens(json_file))
    return _datasets[key]


def _select_sequences(params, all_scenes):
    requested = getattr(params, "sequences", "") or ""
    if isinstance(requested, str) and requested:
        parts = requested.split(",")
        if parts[0].isnumeric():
            return [all_scenes[int(p)] for p in parts
                    if int(p) < len(all_scenes)]
        return [p for p in parts if p in all_scenes]
    return all_scenes


def resolve_paths(params):
    ds = _get_dataset(params)
    scenes = _select_sequences(params, ds.scene_tokens)
    if not scenes:
        raise FileNotFoundError("No nuScenes scenes matched the filter.")
    params.sequences = scenes

    params.images = {
        s: [os.path.join(params.dataset_root, rel)
            for rel in ds.get_filepaths(s)]
        for s in scenes}
    params.depth = {
        s: [os.path.join(params.depth_root,
                         os.path.splitext(os.path.basename(rel))[0]
                         + ".npy")
            for rel in ds.get_filepaths(s)]
        for s in scenes}
    params.calib = {s: None for s in scenes}
    return params


def settings():
    return {
        "cam_hz": CAM_HZ,
        "cam_CCD_WH": list(CCD_WH),
        "cam_CCD_pixsize": PX_SIZE_UM,
        "cam_WH": list(IMAGE_WH),
        "cam_focal": 5.5,        # ~ intrinsics mean * px size (mm)
        "cam_gain": 1.0,
        "cam_f_number": 1.8,
        "cam_focus_plane": 6.0,
        "cam_exposure": EXPOSURE_MS,
        "cam_pos": [1.5, 1.5, 0.3],
        "cam_lookat": [1.5, 1.5, -1.0],
        "cam_up": [0.0, 1.0, 0.0],
        "sequences": {},
    }
