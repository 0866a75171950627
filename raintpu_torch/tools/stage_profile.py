"""Per-stage step anatomy of the render (the port's
``raintpu.tools.stage_profile``).

Times a chain of nested stage functions over the SAME workload and
reports the stage deltas:

    fog         fog only (attenuation + airlight + the stencil blur)
    fog+envmap  + pooled photometry-res envmap
    bg          frame_background (== fog+envmap w/o save outputs)
    prep_photo  bg + cone photometry (env features + drop colors)
    prep_geom   + texture pick + drop geometry
    prep        bg + full drop_fused_params (adds DCT coefs + routing)
    fields      prep + the fused raster kernel (field planes done)
    full        fields + finalize (blend, contrast adjust, crop)

The stages are the port's ``render/frame.py`` functions, on
``--device`` (the CUDA card unless ``--device cpu``), with the field
planes of ``FIELDS_DTYPE`` (an environment variable: float32, the
default, or bfloat16; PipelineConfig.fields_dtype). Each stage runs
``--iters`` times per repetition and reports the median of ``--reps``
repetitions, per step: on the card timed by CUDA events, with a
synchronize before each read; on the CPU by ``time.perf_counter``.
Unlike the JAX tool, the inputs are not perturbed by i·1e-12 from
iteration to iteration: eager PyTorch runs every call it is given and
hoists nothing out of a loop.

``--nuscenes`` profiles the nuScenes 6-camera rig instead: 6 frames of
1600x900 at 100 mm/hr, the simulation capacity sized from the expected
drop count + 5 sigma (rounded up to 256) so the full population is
rendered, the render capacity the largest frame's count (128-aligned),
and a ladder fitted to the population.

Usage:  python -m raintpu_torch.tools.stage_profile [--batch 48]
            [--nuscenes] [--device cuda|cpu] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import envmap as envmap_ops
from raintpu_torch.ops import photometry as photometry_ops
from raintpu_torch.ops import rasterize as raster_ops
from raintpu_torch.ops.rasterize import (BucketSpec, RasterConfig,
                                         fit_raster_config)
from raintpu_torch.particles.schema import compact_drop_batch
from raintpu_torch.physics.simulator import (SimConfig,
                                             expected_drop_count,
                                             simulate_frames)
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings

STAGES = ("fog", "fog+envmap", "bg", "prep_photo", "prep_geom", "prep",
          "fields", "full")
# The bench's hand ladder (ph, pw, radius, capacity, modes_y, modes_x,
# ranks), as bench.py runs it.
HAND_LADDER = (BucketSpec(24, 32, 5, 224, 12, 6, 3),
               BucketSpec(48, 32, 8, 64, 12, 6, 3),
               BucketSpec(96, 64, 12, 32, 24, 10, 4),
               BucketSpec(112, 96, 20, 16, 16, 8, 4))
CONE_DOWNSAMPLE = 4


def full_population_capacity(settings: RenderSettings,
                             fallrate: float) -> int:
    """A simulation capacity that holds a frame's whole drop population:
    the expected count + 5 sigma (Poisson), rounded up to 256."""
    probe = SimConfig.from_settings(settings, capacity=1)
    expect = expected_drop_count(probe, fallrate)
    return int(-(-(expect + 5 * np.sqrt(expect)) // 256) * 256)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--fallrate", type=float, default=10.0)
    ap.add_argument("--capacity", type=int, default=320)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hw", type=int, nargs=2, default=(375, 1242),
                    metavar=("H", "W"))
    ap.add_argument("--nuscenes", action="store_true",
                    help="Profile the nuScenes 6-cam rig instead "
                         "(6x1600x900 @100 mm/hr, full population, "
                         "fitted ladder)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    ap.add_argument("--json", action="store_true")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.nuscenes:
        args.hw = (900, 1600)
        args.batch = 6
        args.fallrate = 100.0
    return args


def workload(args: argparse.Namespace) -> dict:
    """The profiled batch on ``args.device``: settings, config, frames,
    depth, drops, textures, bin edges and the sizes chosen (simulation
    and render capacity)."""
    dev = torch.device(args.device)
    H, W = args.hw
    B = args.batch
    if args.nuscenes:
        settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                        ccd_wh=(W, H)))
        capacity = full_population_capacity(settings, args.fallrate)
    else:
        settings = RenderSettings(camera=CameraSettings())
        capacity = args.capacity
    sim_cfg = SimConfig.from_settings(settings, capacity=capacity)

    def full(v):
        return torch.full((B,), float(v), dtype=torch.float32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    drops = simulate_frames(gen, sim_cfg, full(args.fallrate), full(8.0),
                            full(settings.camera.exposure_s), full(1.0))
    if args.nuscenes:
        render_cap = int(-(-int(drops.count().max()) // 128) * 128)
    else:
        render_cap = capacity
    drops = compact_drop_batch(drops, render_cap)

    db = procedural_streak_database()
    tex = texture_bank(db, device=dev)
    if args.nuscenes:
        raster = fit_raster_config(drops, tuple(tex.raw.shape[1:]), (W, H),
                                   settings)
    else:
        raster = RasterConfig(buckets=HAND_LADDER)
    cfg = frame.PipelineConfig(settings=settings, image_hw=(H, W),
                               fallrate=args.fallrate, raster=raster,
                               fields_dtype=os.environ.get("FIELDS_DTYPE",
                                                           "float32"),
                               cone_downsample=CONE_DOWNSAMPLE)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(B, H, W, 3).astype(np.float32), device=dev)
    depth = torch.as_tensor((rng.rand(B, H, W) * 60 + 3).astype(np.float32),
                            device=dev)
    return dict(cfg=cfg, bg=bg, depth=depth, drops=drops, tex=tex,
                edges=torch.as_tensor(db.bin_edges, device=dev),
                sim_capacity=capacity, render_capacity=render_cap)


def stage_functions(w: dict, gen: torch.Generator) -> dict:
    """Each stage as a function of no arguments over the workload ``w``;
    texture picks (and noise, if the settings ask for it) come from
    ``gen``."""
    cfg, bg, depth, drops = w["cfg"], w["bg"], w["depth"], w["drops"]
    tex, edges = w["tex"], w["edges"]
    st = cfg.settings
    cam = st.camera
    H, W = cfg.image_hw

    def fog():
        return frame.batched_fog(bg, depth, cfg)

    def fog_envmap():
        ds = frame.env_downsamples(cfg)[0]
        geom_lo = envmap_ops.envmap_geometry(H // ds, W // ds, cam.focal)
        fogged = frame.batched_fog(bg, depth, cfg)
        return envmap_ops.generate_envmap(frame._avg_pool_rgb(fogged, ds),
                                          geom_lo), fogged

    def background():
        return frame.frame_background(bg, depth, cfg)

    def photo():
        fogged, env_photo, env_save = frame.frame_background(bg, depth, cfg)
        env = photometry_ops.env_features(
            env_photo, downsample=frame.env_downsamples(cfg)[1])
        mid = (drops.wp1 + drops.wp2) / 2.0
        return photometry_ops.drop_colors(
            mid, env, sphere_radius=st.sphere_radius,
            fov_deg=st.drop_fov_deg, irrad_type=st.irrad_type)

    def geometry():
        gains = photo()
        tex_idx = raster_ops.select_textures(drops, edges, gen)
        noise_deg = None
        if st.noise_scale * st.noise_std != 0.0:
            noise_deg = (torch.randn(drops.valid.shape, generator=gen,
                                     device=drops.valid.device)
                         * st.noise_std * st.noise_scale)
        geom = raster_ops.drop_geometry(
            drops, tuple(tex.raw.shape[1:]), cfg.image_wh,
            focal_m=cam.focal_m, f_number=cam.f_number,
            focus_plane=st.focus_plane, coc_pixsize=cfg.raster.coc_pixsize,
            apply_defocus=st.rendering_strategy is None,
            noise_deg=noise_deg)
        return gains, tex_idx, geom

    def prep():
        fogged, env_photo, env_save = frame.frame_background(bg, depth, cfg)
        return frame.drop_fused_params(env_photo, drops, tex, edges, cfg,
                                       generator=gen)

    def fields():
        return frame.fused_field_planes(bg, depth, drops, tex, edges, cfg,
                                        generator=gen)

    def full():
        return frame.render_frames(bg, depth, drops, tex, edges, cfg,
                                   generator=gen)

    return dict(zip(STAGES, (fog, fog_envmap, background, photo, geometry,
                             prep, fields, full)))


def step_ms(fn, iters: int, reps: int, dev: torch.device) -> float:
    """Median over ``reps`` of the ms per call of ``iters`` calls of
    ``fn``, after one warm-up call: CUDA events on the card (a
    synchronize before each read), ``perf_counter`` on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)) / iters


def deltas(results: dict) -> dict:
    """Each stage's own cost, as the difference of nested stages."""
    r = results
    return {
        "fog": r["fog"],
        "envmap (fog+envmap-fog)": r["fog+envmap"] - r["fog"],
        "bg": r["bg"],
        "photometry (prep_photo-bg)": r["prep_photo"] - r["bg"],
        "geometry (prep_geom-photo)": r["prep_geom"] - r["prep_photo"],
        "coefs+route (prep-geom)": r["prep"] - r["prep_geom"],
        "prep-bg": r["prep"] - r["bg"],
        "kernel (fields-prep)": r["fields"] - r["prep"],
        "finalize (full-fields)": r["full"] - r["fields"],
    }


def card_name() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stage_profile: no CUDA card (pass --device cpu "
                         "to profile the CPU)")
    w = workload(args)
    fns = stage_functions(w, torch.Generator(device=dev).manual_seed(1))
    B = args.batch
    results = {}
    for name in STAGES:
        ms = step_ms(fns[name], args.iters, args.reps, dev)
        results[name] = ms
        if not args.json:
            print(f"{name:10s} {ms:9.3f} ms/step "
                  f"({B / (ms / 1000.0):8.1f} img/s)")
    d = deltas(results)
    rec = {"batch": B, "ms_per_step": results, "deltas_ms": d,
           "backend": dev.type}
    if dev.type == "cuda":
        rec["device"] = card_name()
    if args.json:
        print(json.dumps(rec))
    else:
        print("--- deltas (ms/step) ---")
        for k, v in d.items():
            print(f"{k:26s} {v:9.3f}  ({100 * v / results['full']:.0f}%"
                  " of full)")
    return rec


if __name__ == "__main__":
    main()
