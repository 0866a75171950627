"""nuScenes-GAN dataset plugin: renders rain onto GAN-translated frames
(the port's copy of ``raintpu.data.datasets.nuscenes_gan``).

Same scene structure as :mod:`raintpu_torch.data.datasets.nuscenes`,
but image paths are redirected into the GAN output tree with a filename
postfix (e.g. ``_fake_B``); the particle simulation stays at the
original 1600x900 resolution while rendering happens at the GAN output
resolution (the ``nuscenes_gan`` rescale of the XML loader, reference
``bad_weather.py:213-219``).

The tables are read once per (dataset root, split file, GAN root,
postfix) and kept for the process.
"""

from __future__ import annotations

import os

from raintpu_torch.data.datasets import nuscenes as _nusc
from raintpu_torch.data.nuscenes_data import NuScenesGANCameraData

_datasets = {}


def _get_dataset(params) -> NuScenesGANCameraData:
    json_file = getattr(params, "json_file", None)
    gan_root = getattr(params, "gan_root", params.dataset_root)
    post_fix = getattr(params, "post_fix", "")
    key = (params.dataset_root, json_file, gan_root, post_fix)
    if key not in _datasets:
        _datasets[key] = NuScenesGANCameraData(
            dataroot=params.dataset_root, gan_root=gan_root,
            post_fix=post_fix,
            specific_tokens=_nusc.split_tokens(json_file))
    return _datasets[key]


def resolve_paths(params):
    ds = _get_dataset(params)
    scenes = _nusc._select_sequences(params, ds.scene_tokens)
    if not scenes:
        raise FileNotFoundError("No nuScenes scenes matched the filter.")
    params.sequences = scenes
    root = ds.gan_root
    params.images = {
        s: [os.path.join(root, rel) for rel in ds.get_filepaths(s)]
        for s in scenes}
    params.depth = {
        s: [os.path.join(params.depth_root,
                         os.path.splitext(os.path.basename(rel))[0].replace(
                             ("_" + ds.post_fix) if ds.post_fix else "", "")
                         + ".npy")
            for rel in ds.get_filepaths(s)]
        for s in scenes}
    params.calib = {s: None for s in scenes}
    return params


def settings():
    return _nusc.settings()
