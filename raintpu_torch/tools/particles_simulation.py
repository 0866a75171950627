"""Batch particle-simulation tool (reference ``tools/particles_simulation.py``).

The port's counterpart of ``raintpu.tools.particles_simulation``: the
port's simulator (:func:`raintpu_torch.physics.simulator.simulate_frames`)
runs on ``device`` (the CUDA card unless the caller asks for the CPU),
every frame of a weather in one call, drawing from
``torch.Generator(device).manual_seed(seed)``, and writes the XML in
the reference interchange format with the same layout:

    PARTICLES_ROOT/DATASET/SEQ/rain/{N}mm/0000_camera0.xml
                                         /sim_options.json
                                         /automate_log.txt

Usage mirrors the reference:
    python -m raintpu_torch.tools.particles_simulation   # edit __main__ lists
or programmatically via :func:`process` / :func:`process_sequences`.
"""

from __future__ import annotations

import json
import os
import time
from typing import List

import numpy as np
import torch

from raintpu_torch import resolve_device
from raintpu_torch.particles import xml_io
from raintpu_torch.physics.simulator import (SimConfig, schedule_from_settings,
                                             simulate_frames)
from raintpu_torch.render.camera import settings_from_dict


def simulate_to_xml(output_dir: str, options: dict, weather: dict,
                    redo: bool = False, capacity: int = 4096,
                    seed: int = 0, verbose: bool = True,
                    device=None) -> str:
    """Run one simulation on ``device`` (None: the CUDA card) and persist
    XML + provenance files."""
    os.makedirs(output_dir, exist_ok=True)
    existing = [f for f in os.listdir(output_dir) if "camera0.xml" in f]
    if existing and not redo:
        if verbose:
            print(f" Simulation exists: {output_dir}, skipping")
        return os.path.join(output_dir, existing[0])

    device = resolve_device(device)
    t0 = time.time()
    log_lines = ["raintpu_torch particle simulation",
                 f"weather={weather} seed={seed} capacity={capacity} "
                 f"device={device}"]

    # Provenance json (reference simulation.py:271-281).
    options_native = {
        k: (v.tolist() if isinstance(v, np.ndarray) else v)
        for k, v in options.items() if k != "sequences"}
    if "sim_steps" in options_native:
        options_native["sim_steps"] = {
            k: (np.asarray(v).tolist())
            for k, v in dict(options_native["sim_steps"]).items()}
    with open(os.path.join(output_dir, "sim_options.json"), "w") as fh:
        json.dump(options_native, fh)

    settings = settings_from_dict(options)
    cfg = SimConfig.from_settings(settings, capacity=capacity)
    fall, speed, expo, fscale = (torch.as_tensor(a, device=device) for a in
                                 schedule_from_settings(
                                     settings, weather["fallrate"]))
    batch = simulate_frames(torch.Generator(device=device).manual_seed(seed),
                            cfg, fall, speed, expo, fscale)
    raw = xml_io.batch_to_raw_frames(
        batch, cfg.image_wh, cam_hz=cfg.cam_hz,
        exposure_s=float(expo[0]), render_scale=cfg.render_scale)
    path = os.path.join(output_dir, "0000_camera0.xml")
    xml_io.write_particles_xml(path, raw)

    counts = batch.count().cpu().numpy()
    log_lines.append(
        f"frames={len(raw)} drops/frame mean={counts.mean():.1f} "
        f"max={counts.max()} wall={time.time() - t0:.2f}s")
    with open(os.path.join(output_dir, "automate_log.txt"), "a") as fh:
        fh.write("\n".join(log_lines) + "\n")
    if verbose:
        print(f" #sim {output_dir}: {log_lines[-1]}")
    return path


def process(sim: dict, force_recompute: bool = False,
            capacity: int = 4096, seed: int = 0, device=None) -> List[str]:
    """Reference-compatible entry: sim = {"path": [...], "options": [...],
    "weather": [...]} (see main.py:206-208)."""
    out = []
    for weather in sim["weather"]:
        for path, options in zip(sim["path"], sim["options"]):
            output_dir = os.path.join(
                path, weather["weather"], f'{weather["fallrate"]}mm')
            out.append(simulate_to_xml(output_dir, options, weather,
                                       redo=force_recompute,
                                       capacity=capacity, seed=seed,
                                       device=device))
    return out


def process_sequences(sequences, weathers, force_recompute: bool = False,
                      particles_root: str = os.path.join("data",
                                                         "particles"),
                      device=None):
    """sequences: [(dataset, sequence), ...] like the reference
    __main__ block."""
    from raintpu_torch.data import db

    spec = {"path": [], "options": [], "weather": weathers}
    for ds, seq in sequences:
        sim = db.sim(ds, os.path.normpath(seq),
                     os.path.join(particles_root, ds))
        spec["path"].append(sim["path"])
        spec["options"].append(sim["options"])
    return process(spec, force_recompute=force_recompute, device=device)


if __name__ == "__main__":
    sequences = [
        ["kitti", "data_object"],
        ["kitti", "raw_data/2011_09_26/2011_09_26_drive_0032_sync"],
        ["kitti", "raw_data/2011_09_26/2011_09_26_drive_0056_sync"],
        ["cityscapes", "leftImg8bit"],
    ]
    weathers = [{"weather": "rain", "fallrate": f}
                for f in [1, 2, 3, 4, 5, 10, 20, 25, 30, 40, 50,
                          60, 70, 80, 90, 100, 150, 200]]
    process_sequences(sequences, weathers)
