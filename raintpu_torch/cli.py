"""Command-line interface of the PyTorch port.

    python -m raintpu_torch.cli --dataset customdb --intensity 10,50 \\
        [--online [--export_xml]] [--device cuda|cpu] [--save_saturation]
        [--save_envmap] [--raster_profile default|fitted|tiny] ...

The flags of the JAX package's CLI (``raintpu.cli``, itself
flag-compatible with the reference ``main.py``), plus ``--device``: the
job renders on the CUDA card unless ``--device cpu`` is given. Without
``--online`` the job reads the reference's particle XML files
(``PARTICLES/DATASET/SEQ/rain/{N}mm/*_camera0.xml``), first simulating
the missing ones with :mod:`raintpu_torch.tools.particles_simulation`
on the same device; with ``--online`` drops are simulated per frame on
the device, and ``--export_xml`` also writes them as XML files in that
layout.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from types import SimpleNamespace

from raintpu_torch.data import db
from raintpu_torch.utils.logging import print_warning


def particles_glob(path: str, weather: dict) -> str:
    """Per-weather XML search pattern (reference my_utils.py:172-173)."""
    return os.path.join(path, weather["weather"],
                        f'{weather["fallrate"]}mm', "*_camera0.xml")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="raintpu_torch — physics-based rain rendering in "
                    "PyTorch")
    p.add_argument("--dataset", required=True,
                   help="Dataset name; data under DATASET_ROOT/DATASET")
    p.add_argument("-k", "--dataset_root",
                   default=os.path.join("data", "source"))
    p.add_argument("-p", "--post_fix", default="", type=str,
                   help="Postfix of GAN-modified files (nuscenes_gan)")
    p.add_argument("--json_file", default=None,
                   help="nuScenes split file with sample_data_tokens")
    p.add_argument("-g", "--gan_root",
                   default=os.path.join("data", "gan"),
                   help="GAN-translated dataset root (nuscenes_gan)")
    p.add_argument("-s", "--sequences", default="",
                   help="Comma-separated sequence filter (prefix match)")
    p.add_argument("-ns", "--noise_scale", type=float, default=0.0)
    p.add_argument("-nv", "--noise_std", type=float, default=0.0)
    p.add_argument("-oa", "--opacity_attenuation", type=float, default=1.0)
    p.add_argument("-r", "--particles",
                   default=os.path.join("data", "particles"))
    p.add_argument("-sd", "--streaks_db",
                   default=os.path.join("3rdparty", "rainstreakdb"))
    p.add_argument("-i", "--intensity", type=str, default="25",
                   help="Fall rates (mm/hr), comma separated")
    p.add_argument("-d", "--depth", default=os.path.join("data", "source"))
    p.add_argument("-fs", "--frame_start", type=int, default=0)
    p.add_argument("-fe", "--frame_end", type=int, default=None)
    p.add_argument("-fst", "--frame_step", type=int, default=1)
    p.add_argument("-ff", "--frames", type=str, default="")
    p.add_argument("--conflict_strategy", type=str, default="overwrite",
                   choices=["overwrite", "skip", "rename_folder"])
    p.add_argument("--rendering_strategy", type=str, default=None,
                   choices=[None, "white", "naive_db"])
    p.add_argument("--output", default=os.path.join("data", "output"))
    p.add_argument("--save_envmap", action="store_true")
    p.add_argument("--save_saturation", action="store_true",
                   help="Also compute + save the per-frame saturation "
                        "mask (reference bad_weather.py:450-460)")
    p.add_argument("--env_type", type=str, default="ours",
                   choices=["ours", "pano"],
                   help="'ours' extrapolates the envmap from the frame; "
                        "'pano' loads captured panoramas per frame")
    p.add_argument("--panos", default=os.path.join("data", "panos"),
                   help="With --env_type pano: directory of per-frame "
                        "panoramas named like the frame files")
    p.add_argument("--noverbose", action="store_true")
    p.add_argument("--force_particles", action="store_true",
                   help="Re-run particle simulation even if files exist")
    p.add_argument("--online", action="store_true",
                   help="Simulate particles on the device; no XML needed")
    p.add_argument("--export_xml", action="store_true",
                   help="With --online: also write reference-format XML")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--drop_capacity", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--raster_profile", type=str, default="default",
                   choices=("default", "fitted", "tiny"),
                   help="Bucket ladder: 'default' (fixed 4 rungs), "
                        "'fitted' (fitted to the weather's first 8 frames "
                        "of drops) or 'tiny' (tests)")
    p.add_argument("--cone_downsample", type=int, default=4,
                   help="Block-reduction of the cone-photometry envmap "
                        "features; 1 = exact")
    p.add_argument("--save_format", type=str, default="png",
                   choices=("png", "npy"),
                   help="Output encoding: png (reference contract; needs "
                        "PIL and matplotlib) or npy raw arrays (rainy "
                        "uint8, mask float32; needs numpy only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device to render on (default: the CUDA "
                        "card; 'cpu' runs every kernel's plain version)")
    return p


def check_args(argv):
    """Parse + resolve everything up to a runnable JobSpec: streak-DB
    checks, plugin path resolution, sequence validation and particle-file
    resolution with simulation of the missing files, in the reference's
    order (main.py:127-222)."""
    args = build_parser().parse_args(argv)
    if args.force_particles and args.conflict_strategy == "skip":
        raise SystemExit(
            "--force_particles cannot be combined with skip strategy")

    args.verbose = not args.noverbose
    args.texture = os.path.join(args.streaks_db, "env_light_database",
                                "size32")
    args.norm_coeff = os.path.join(args.streaks_db, "env_light_database",
                                   "txt", "normalized_env_max.txt")
    if not os.path.isdir(args.texture):
        print_warning(
            f"rainstreakdb not found at {args.streaks_db}; using the "
            "built-in procedural streak bank.")
        args.texture = None
        args.norm_coeff = None

    args.intensity = [int(i) for i in args.intensity.split(",")]
    args.frames = [int(i) for i in args.frames.split(",")] \
        if args.frames else None

    dataset_name = args.dataset[:-4] if args.dataset.endswith("_gan") \
        else args.dataset
    args.dataset_root = os.path.join(args.dataset_root, dataset_name)
    args.depth_root = os.path.join(args.depth, dataset_name)
    args.images_root = args.dataset_root
    args.calib = None
    if not os.path.isdir(args.images_root):
        raise SystemExit(f"Dataset folder missing: {args.images_root}")

    seq_filter = args.sequences.split(",")
    params = db.resolve_paths(args.dataset, args)
    settings = db.settings(args.dataset)

    sequences = [s for s in params.sequences
                 if any(str(s).startswith(f) for f in seq_filter)]
    weather = [{"weather": "rain", "fallrate": i} for i in args.intensity]

    # Validate sequences (images/depth/calib presence).
    print(f"\n{len(sequences)} sequence(s) found: {list(sequences)}")
    valid_seqs = []
    for seq in sequences:
        ok = True
        img = params.images[seq]
        if not (isinstance(img, (list, tuple)) or os.path.exists(img)):
            print(f" Skip '{seq}': images folder missing {img}")
            ok = False
        dep = params.depth[seq]
        if not (isinstance(dep, (list, tuple)) or os.path.exists(dep)):
            print(f" Skip '{seq}': depth folder missing {dep}")
            ok = False
        cal = params.calib[seq]
        if cal is not None:
            paths = cal if isinstance(cal, list) else [cal]
            if not all(os.path.exists(c) for c in paths):
                print(f" Skip '{seq}': calib missing {cal}")
                ok = False
        if ok:
            valid_seqs.append(seq)
    print(f"{len(valid_seqs)} valid sequence(s)")

    # Resolve particle simulations.
    particles_root = os.path.join(args.particles, args.dataset)
    particles = {}
    if args.online:
        particles = {seq: [None] * len(weather) for seq in valid_seqs}
    else:
        sims_to_run = []
        sim_specs = {}
        for seq in valid_seqs:
            sim_specs[seq] = db.sim(args.dataset, seq, particles_root)
            missing = [w for w in weather
                       if not glob.glob(particles_glob(
                           sim_specs[seq]["path"], w))
                       or args.force_particles]
            if missing:
                sims_to_run.append({"path": [sim_specs[seq]["path"]],
                                    "options": [sim_specs[seq]["options"]],
                                    "weather": missing})
        if sims_to_run:
            print(f" {len(sims_to_run)} particle simulation(s) to compute "
                  f"— running the simulator on {args.device}...")
            from raintpu_torch.tools import particles_simulation
            for spec in sims_to_run:
                particles_simulation.process(spec, force_recompute=True,
                                             device=args.device)
        for seq in valid_seqs:
            try:
                particles[seq] = [
                    glob.glob(particles_glob(sim_specs[seq]["path"], w))[0]
                    for w in weather]
            except IndexError:
                print_warning(
                    f"No particle file for sequence {seq}; skipping it.")
    valid_seqs = [s for s in valid_seqs if s in particles]

    return SimpleNamespace(
        args=args, settings=settings, sequences=valid_seqs,
        images=params.images, depth=params.depth, calib=params.calib,
        particles=particles, weather=weather)


def main(argv=None) -> int:
    ns = check_args(sys.argv[1:] if argv is None else argv)
    a = ns.args

    from raintpu_torch.render.pipeline import JobSpec, RenderJob
    if a.online:
        from raintpu_torch.render.online import OnlineRenderJob as Job
    else:
        Job = RenderJob

    spec = JobSpec(
        dataset=a.dataset, sequences=ns.sequences, images=ns.images,
        depth=ns.depth, calib=ns.calib, particles=ns.particles,
        weather=ns.weather, settings=ns.settings, output_root=a.output,
        streaks_db=a.texture, norm_coeff=a.norm_coeff,
        conflict_strategy=a.conflict_strategy,
        rendering_strategy=a.rendering_strategy,
        save_envmap=a.save_envmap, save_saturation=a.save_saturation,
        env_type=a.env_type, panos_dir=a.panos,
        frame_start=a.frame_start, frame_end=a.frame_end,
        frame_step=a.frame_step, frames=a.frames,
        noise_scale=a.noise_scale, noise_std=a.noise_std,
        opacity_attenuation=a.opacity_attenuation, verbose=a.verbose,
        batch_size=a.batch_size, drop_capacity=a.drop_capacity,
        seed=a.seed, raster_profile=a.raster_profile,
        cone_downsample=a.cone_downsample, save_format=a.save_format,
        device=a.device)
    job = Job(spec)
    if a.online and a.export_xml:
        job.export_xml = True
    stats = job.run()
    if a.online and a.export_xml:
        for path in job.finish_export(
                os.path.join(a.particles, a.dataset)):
            print(f"Exported particle XML: {path}")
    print(f"\nDone: {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
