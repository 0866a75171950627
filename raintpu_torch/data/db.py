"""Dataset settings + config-plugin system.

The port's copy of ``raintpu.data.db``: the reference's plugin contract
(``common/db.py:73-122``, the public extension API of its
``README.md:162-243``). A dataset module exports

    resolve_paths(params) -> params   # fills sequences/images/depth/calib
    settings() -> dict                # overrides over the defaults below

Plugins are searched in order:
1. a user ``config.<name>`` module on sys.path — so config plugins
   written against the reference work unchanged;
2. ``raintpu_torch.data.datasets.<name>`` (built-ins: kitti, customdb,
   cityscapes, nuscenes, nuscenes_gan).

Settings keys and semantics are identical to the reference defaults
(``common/db.py:8-70``); per-sequence overrides are selected by regex
match on the sequence path (``common/db.py:109-122``).
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Dict

import numpy as np


def default_settings() -> Dict:
    return {
        # Camera intrinsics
        "cam_hz": 10,                    # frame rate (Hz)
        "cam_CCD_WH": [1242, 375],       # CCD size (px)
        "cam_CCD_pixsize": 4.65,         # CCD pixel size (µm)
        "cam_WH": [1242, 375],           # image size (px)
        "cam_focal": 6,                  # focal length (mm)
        "cam_gain": 20,                  # camera gain
        "cam_f_number": 6.0,
        "cam_focus_plane": 6.0,          # focus distance (m)
        "cam_exposure": 2,               # exposure (ms)
        # Camera extrinsics (right-handed)
        "cam_pos": [1.5, 1.5, 0.3],
        "cam_lookat": [1.5, 1.5, -1.0],
        "cam_up": [0.0, 1.0, 0.0],
        # Renderer scales (see camera.RenderSettings docstring)
        "depth_scale": 1,
        "render_scale": 1,
        # Particle simulation (normal: fixed duration; steps: one step
        # per camera frame with per-step parameter lists)
        "sim_hz": 2000,
        "sim_mode": "normal",
        "sim_duration": 34.0,
        "sim_steps": {},
        # Per-sequence overrides, keyed by sequence-path regex
        "sequences": {},
    }


_plugin_cache: Dict[str, object] = {}


def _load_plugin(name: str):
    if name in _plugin_cache:
        return _plugin_cache[name]
    errors = []
    # User config modules take precedence over the built-ins so projects
    # can override datasets without touching the package.
    for modname in (f"config.{name}",
                    f"raintpu_torch.data.datasets.{name}"):
        try:
            mod = importlib.import_module(modname)
            _plugin_cache[name] = mod
            return mod
        except ImportError as e:
            errors.append(f"{modname}: {e}")
    raise ImportError(
        f"No dataset plugin '{name}'. Tried:\n  " + "\n  ".join(errors))


def resolve_paths(name: str, params):
    """Run the plugin's path resolution and validate its contract."""
    params = _load_plugin(name).resolve_paths(params)
    for attr in ("images", "depth", "calib"):
        if not hasattr(params, attr) or getattr(params, attr) is None:
            raise ValueError(
                f"Dataset plugin '{name}' must set params.{attr} "
                "(set calib to {seq: None} if no KITTI-format calibration).")
    return params


def settings(name: str) -> Dict:
    """Defaults merged with the plugin's overrides + validation."""
    merged = {**default_settings(), **_load_plugin(name).settings()}
    merged["sequences"] = {
        os.path.normpath(k).replace("\\", os.sep): v
        for k, v in merged["sequences"].items()}
    assert_settings(merged)
    return merged


def assert_settings(s: Dict) -> None:
    """Reference ``common/db.py:103-107``."""
    if not (isinstance(s["render_scale"], int) and s["render_scale"] >= 1):
        raise ValueError("render_scale must be an int >= 1")
    if s["cam_exposure"] > 1000.0 / s["cam_hz"]:
        raise ValueError(
            "cam_exposure must be <= 1000/cam_hz or frames overlap "
            "temporally.")
    if s["cam_lookat"][2] >= 0:
        raise ValueError("cam_lookat z must be negative.")
    if not np.isclose(np.linalg.norm(np.asarray(s["cam_up"])), 1.0):
        raise ValueError("cam_up must have unit norm.")


def sim(name: str, sequence: str, particles_root: str) -> Dict:
    """Per-sequence simulation spec: output path + merged options.

    Sequence-specific settings are chosen by regex match of the
    configured key against the sequence path; '*' in matched keys maps
    to 'x' in the output path (reference ``common/db.py:109-122``).
    """
    s = settings(name)
    spec = {"path": os.path.join(particles_root, sequence),
            "options": dict(s)}
    matches = [k for k in s["sequences"]
               if re.match(k.replace("\\", "\\\\"), sequence) is not None]
    if matches:
        k = matches[0]
        spec["path"] = os.path.join(particles_root, k.replace("*", "x"))
        spec["options"] = {**spec["options"], **s["sequences"][k]}
        spec["options"].pop("sequences", None)
    else:
        print(f" No sequence-specific simulation settings for "
              f"'{sequence}' in dataset '{name}'; using dataset defaults.")
    return spec
