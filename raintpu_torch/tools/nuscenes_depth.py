"""Precompute dense LiDAR depth maps for nuScenes rendering.

The port's copy of ``raintpu.tools.nuscenes_depth``: the renderer reads
nuScenes depth as one ``.npy`` per camera frame; this tool makes them
from the raw dataset (no devkit needed), each map rasterized on
``--device`` (the CUDA card unless ``--device cpu``):

    python -m raintpu_torch.tools.nuscenes_depth DATAROOT OUT
        [--version V] [--scenes 0,1,2] [--sensor CAM_FRONT]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from raintpu_torch.data.nuscenes_data import NuScenesCameraData
from raintpu_torch.utils.logging import progress_bar


def process(dataroot: str, out_dir: str, version: str = "v1.0-trainval",
            sensor: str = "CAM_FRONT", scenes=None, device=None) -> int:
    """Write OUT/NAME.npy for every frame of the chosen scenes (all by
    default) that has none yet; returns the number written."""
    ds = NuScenesCameraData(dataroot, version=version, sensor=sensor)
    scene_tokens = ds.scene_tokens
    if scenes:
        scene_tokens = [scene_tokens[i] for i in scenes]
    os.makedirs(out_dir, exist_ok=True)

    n = 0
    for s_i, scene in enumerate(scene_tokens):
        chain = ds._chain(scene)
        for i, tok in enumerate(chain):
            sd = ds.db.get("sample_data", tok)
            name = os.path.splitext(os.path.basename(sd["filename"]))[0]
            out = os.path.join(out_dir, name + ".npy")
            if os.path.exists(out):
                continue
            depth = ds.dense_depth_map(tok, device=device)
            np.save(out, depth.cpu().numpy())
            n += 1
            progress_bar(i + 1, len(chain),
                         prefix=f"scene {s_i + 1}/{len(scene_tokens)}")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataroot")
    ap.add_argument("out")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--sensor", default="CAM_FRONT")
    ap.add_argument("--scenes", default="",
                    help="Comma-separated scene indices (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device of the depth rasterization "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    scenes = [int(s) for s in args.scenes.split(",")] if args.scenes else None
    n = process(args.dataroot, args.out, args.version, args.sensor, scenes,
                args.device)
    print(f"\nWrote {n} depth maps to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
