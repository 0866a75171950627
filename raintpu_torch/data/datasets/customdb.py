"""Template plugin for custom datasets (reference ``config/customdb.py``).

Layout expected under the dataset root:

    DATASET/
      SEQ1/rgb/*.png      source images
      SEQ1/depth/*.png    16-bit depth (meters * 256) or .npy meters

To onboard a new dataset, copy this module to ``config/<name>.py`` (or
``raintpu_torch/data/datasets/<name>.py``) and adapt ``resolve_paths`` /
``settings``; then run ``python -m raintpu_torch.cli --dataset <name>``.
"""

from __future__ import annotations

import os


def resolve_paths(params):
    params.sequences = [d for d in os.listdir(params.images_root)
                        if os.path.isdir(os.path.join(params.images_root, d))]
    if len(params.sequences) == 0:
        raise FileNotFoundError("No sequence folders in the dataset root.")
    params.images = {s: os.path.join(params.dataset_root, s, "rgb")
                     for s in params.sequences}
    params.depth = {s: os.path.join(params.dataset_root, s, "depth")
                    for s in params.sequences}
    params.calib = {s: None for s in params.sequences}
    return params


def settings():
    return {
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
        "sequences": {
            # Example sequence-specific overrides (regex-matched against
            # the sequence path):
            # a plain 10 s simulation,
            "seq1": {"sim_mode": "normal", "sim_duration": 10},
            # per-frame camera speeds (km/h),
            "seq2": {"sim_mode": "steps",
                     "sim_steps": {"cam_motion": [100.0, 90.0, 80.0, 70.0,
                                                  60.0, 50.0, 40.0, 30.0,
                                                  20.0, 10.0, 0.0]}},
            # per-frame fall rates (mm/hr) — overrides --intensity.
            "seq3": {"sim_mode": "steps",
                     "sim_steps": {"rain_fallrate": [30, 26, 22, 18, 14,
                                                     10, 6, 2]}},
        },
    }
