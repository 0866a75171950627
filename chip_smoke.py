"""Smoke run of the PyTorch port (raintpu_torch) on one NVIDIA GPU.

Drives the port's four paths and checks them. The benchmark workload —
KITTI 1242x375 at 10 mm/hr, batch 48, drops simulated on the card and
packed to capacity 320, the four-rung hand ladder, cone_downsample 4
with env_fold, five float32 planes — the online CLI path
(``raintpu_torch.cli.main --online``) and the offline CLI path (no
``--online``: particle XML simulated by the port's tool, parsed by the
native parser, the fitted ladder) on a 16-frame KITTI-size customdb
dataset with the saturation mask and the envmap, the nuScenes path
(the depth tool, the online CLI at 100 mm/hr, depth smoothing and the
6-camera rig's stage profile), the sharded render
(``raintpu_torch.parallel``) and the render farm
(``python -m raintpu_torch.main_threaded``), and the golden render path
(``composite_mode="xla"``: patches first, then a scatter, the
independent algorithm the fused kernel is held to). Phases:

  1. device: a CUDA card is required; prints its name, its
     ``nvidia-smi`` name and power limit, and the TF32 flags (off);
  2. build: compiles both CUDA kernels and the XML parser from
     raintpu_torch/csrc/ (one compiler per source, in parallel);
  3. workload: drops, frames and the texture bank, with the port's code;
  4. kernel against plain: the fused raster kernel and its plain
     PyTorch version on every rung's operands of this batch, one rung a
     call and all rungs in one call;
  5. render: ``render_frames`` on the batch — finite outputs, rain mask
     mass > 1, no bucket overflow, one raster launch and one blur
     launch — and the first two frames against the same render on the
     CPU (plain path);
  6. timing (information, not a claim): images/s of the render with the
     float inputs perturbed each iteration, and kernel vs plain ms, the
     kernel also under other image tiles (TILE_HW);
  7. sharded: the bench batch through ``render_frames_sharded`` in a
     one-rank nccl group, torch.equal to ``render_frames`` with one
     raster and one blur launch; then two ranks on the one card
     (spawned processes, gloo) on its first 8 frames, as dp 1 x sp 2
     (each rank half of every frame's drops, the planes all-reduced;
     within 1e-5 of one rank, alpha mass within 1e-5 relative, the
     overflow summed equal, the raster kernel against plain on rank 1's
     operands) and as dp 2 x sp 1 (within 1e-6);
  8. blur: the fog stage's stencil kernel against its plain version on
     the CLI and bench fog stacks, odd and multi-fold shapes, with
     kernel, plain, conv2d and bound ms, and the kernel under other tile
     shapes;
  9. multitile: the raster kernel with 8 planes on every rung of the
     default ladder at KITTI size, the multi-tile rungs included, one
     rung a call and all rungs in one call, timed under several image
     tiles, and one launch with every slot empty against a plain
     ``torch.zeros`` of the same planes;
 10. determinism: two launches on the bench rungs and on the default
     ladder's rungs give the same bits;
 10a. golden: the golden path on the card — (a) A's batch against the
     fused kernel on the same texture picks within 2e-4 but for cutoff
     flips (GOLDEN_ATOL), 0 raster and 1 blur launch during the golden
     render, overflow 0 on both; (b) the [multitile] batch (B's default
     ladder, 8 planes) the same, the saturation mask included; (c)
     texture_mode "gather" (supersample 2) on A's frames 0-1 against
     the CPU within the render bars; (d) the one-rank nccl sharded
     render's xla branch within 1e-6 of render_frames'; (e) images/s of
     both paths on A in turns and each one's peak memory (information);
 11. cli: ``cli.main --online`` renders the dataset on the card;
     outputs, one raster launch per batch carrying every rung, and the
     first two frames against the CPU render of the same drops and
     texture picks;
 12. farm: the farm over the [cli] dataset at 25 and 50 mm/hr in frame
     windows of 8 (4 children), one at a time and two at a time: every
     child exits 0, every frame's outputs exist, the 25 mm/hr frames
     equal the [cli] job's within 1e-5, and a rerun skips every frame
     and rewrites no file; wall time and images/s (information);
 13. stages: stage times of one CLI batch, the raster stage rung by rung;
 14. offline: ``cli.main`` without ``--online`` and with the fitted
     ladder: the tool writes the XML, the native parser reads it, the
     .npz cache is written; outputs, one raster and one blur launch per
     batch, frames 0-1 against the CPU render; the ladder fitted on the
     card beside the one fitted on the CPU from the same sample, the
     tool's time, the XML's size, parse ms per frame (native, Python);
 15. regimes: on the offline run's first batch, the raster kernel
     against plain and two launches bit-identical on the operands of
     the fitted ladder, 'white', 'naive_db' and streak noise; the
     renders of white, naive_db, noise and a synthetic pano on the card
     against the CPU render of frames 0-1; raster ms per regime;
 16. export: a 4-frame online run with ``--export_xml`` whose XML,
     re-parsed, holds every frame's simulated drops;
 17. nuscenes depth: a synthetic nuScenes tree made from a seed (the
     v1.0-trainval tables, one scene of 12 CAM_FRONT frames of 1600x900
     as .npy, a 34,000-point LIDAR_TOP sweep per frame, the ego at
     10 m/s); the port's depth tool writes every frame's map on the card,
     and frames 0-1 must equal the CPU's maps bit for bit;
 18. nuscenes cli: ``cli.main --dataset nuscenes --online`` at 100 mm/hr
     with the fitted ladder, batches of 6, the envmap saved, and the
     simulation capacity sized to the whole population: nothing
     truncated or overflowed, one raster and one blur launch per batch,
     frame 0 against the CPU render of the same drops and texture picks;
 19. depth blur: ``tools.smooth_depth.improve_depth`` on a 900x1600 map
     on the card (one launch of the blur kernel at 7 taps) against the
     same smoothing on the CPU, and the 7-tap blur against its plain
     version;
 20. nuscenes rig: ``tools.stage_profile --nuscenes`` (6 frames of
     1600x900 at 100 mm/hr, the full population, a fitted ladder): stage
     times, then on that batch the raster kernel against its plain
     version (rung by rung and all rungs in one launch), two launches
     bit-identical, raster ms against its bound, the fog's blur at
     (24, 900, 1600) and the device's busy share.

Each kernel time is printed beside the one recorded for the kernel's
first design (one block per drop for the raster kernel, 32x128 tiles
with one shared load per tap for the blur) and, for the raster kernel,
its previous design's (row chunks, one launch per rung; PERF.md section
6). Each phase's wall time is printed after it.

Prints a kernels JSON line (launches by path: bench, cli, offline,
regimes, nuscenes, the one-rank sharded render, the golden render of A
(raster 0, blur 1), and depth for the blur;
the two-rank and farm children launch in processes of their own and
are not counted), then ``{"ok": true, "device": ...}`` as the last
line. Any failing phase raises and the script exits non-zero.

Run from the repository root:  python3 chip_smoke.py
"""

import ast
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from raintpu_torch import cli, cuda_build
from raintpu_torch.data import db
from raintpu_torch.data.nuscenes_data import NuScenesCameraData
from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import blur_kernel, fog, fused_raster, rasterize
from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur_hw
from raintpu_torch.ops.fused_raster import (ALPHA_CUTOFF, N_PLANES,
                                            N_PLANES_SAT)
from raintpu_torch.ops.rasterize import RasterConfig, select_textures
from raintpu_torch.parallel import distributed
from raintpu_torch.parallel import mesh as pmesh
from raintpu_torch.particles import native, xml_io
from raintpu_torch.particles.schema import TYPE_BIG, compact_drop_batch
from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                             simulate_frames,
                                             simulate_frames_keyed)
from raintpu_torch.render import frame, pipeline
from raintpu_torch.render.camera import (CameraSettings, RenderSettings,
                                         settings_from_dict)
from raintpu_torch.tools import (nuscenes_depth, particles_simulation,
                                 smooth_depth, stage_profile)

H, W = 375, 1242
BATCH = 48
FALLRATE = 10.0
CAPACITY = 320
SIM_CAPACITY = 512
# Kernel against plain: the same float32 operations, each pixel's sums
# in the same order (the kernel is built with --fmad=false); cos, tanh
# and log round differently on the card.
KERNEL_ATOL = 1e-5
KERNEL_RTOL = 1e-5
# GPU render against the CPU render of the same frames. Matmul sums and
# transcendentals round differently on the two devices, which moves
# values by ~1e-7 — except at the model's discontinuities: a pixel whose
# alpha sits at ALPHA_CUTOFF (2e-4) can drop to 0 on one side, and the
# Small/Medium warp canvas width floor(th*|sin| + tw*|cos|) flips by one
# texel for a streak whose (dx, dy) is a Pythagorean pair such as
# (5, 12), where the sum is an integer. A flip moves a streak's whole
# footprint (~100 px). Measured on an H100 (frames 0-1, 931,500 mask
# pixels): max 1.9e-3, mean 9e-8, 1.4e-4 of the pixels off by > 2e-4.
# So: a bound on the largest difference such a flip can give, and room
# for about nine flipped streaks of the ~470 in the two frames.
RENDER_MAX_ABS = 5e-3
RENDER_FAR = 2e-4
RENDER_MAX_FAR_FRACTION = 1e-3
KERNEL_SOURCE = "raintpu_torch/csrc/fused_raster.cu"
KERNEL_REPLACES = "raintpu/ops/pallas/fused_kernel.py:1318"
K2_REPLACES = "raintpu/ops/pallas/fused_kernel.py:274"
K3_REPLACES = "raintpu/ops/pallas/fused_kernel.py:1165"
BLUR_SOURCE = "raintpu_torch/csrc/separable_blur.cu"
BLUR_REPLACES = "raintpu/ops/pallas/blur_kernel.py:282"
# The blur kernel against its plain version (dense band matmuls): the
# same products, summed in another order.
BLUR_ATOL = 1e-5

# The online CLI path: customdb at KITTI size, the default ladder.
CLI_FRAMES = 16
CLI_BATCH = 8
CLI_FALLRATE = 25
CLI_CAPACITY = 2048       # the CLI's --drop_capacity default
# The JAX package's window plan (fused_kernel.plan_window): windows over
# MAX_SLAB_AREA run in row tiles, the multi-tile kernel body (K2).
MAX_SLAB_AREA = 80_000

# The nuScenes path: one second of CAM_FRONT (12 frames at 12 Hz) at
# 1600x900 through the online CLI at 100 mm/hr, batches of 6 (the
# 6-camera rig's batch); LiDAR sweeps of a 32-beam LIDAR_TOP's size.
NUSC_FRAMES = 12
NUSC_BATCH = 6
NUSC_FALLRATE = 100
NUSC_HW = (900, 1600)
NUSC_POINTS = 34_000
NUSC_SPEED_MPS = 10.0
# smooth_depth on the card against the CPU: metres, float32 sums of the
# 7 taps in another order.
DEPTH_ATOL = 1e-4
DEPTH_RTOL = 1e-5

# The sharded render: (a) one rank on the bench batch; (b) two ranks on
# the one card (gloo: NCCL takes one rank a GPU) on its first PAIR_BATCH
# frames, as dp 1 x sp 2 and as dp 2 x sp 1.
PAIR_BATCH = 8
PAIR_TIMEOUT_S = 300
# sp 2 against one rank: the same contributions, each half of a frame's
# drops summed on its own rank and the two planes then added, so float32
# sums in another order (tests/test_sharding.py's bars).
SHARD_ATOL = 1e-5
SHARD_MASS_RTOL = 1e-5
# dp 2 against one rank: every frame rendered whole on one rank; only a
# library's choice of algorithm by batch size may move a value.
DP_ATOL = 1e-6
# The farm: python -m raintpu_torch.main_threaded over the [cli] phase's
# dataset, 2 intensities x 2 windows of CLI_BATCH frames = 4 children.
FARM_INTENSITIES = (CLI_FALLRATE, 50)
FARM_ATOL = 1e-5
FARM_TIMEOUT_S = 420

# The golden path (composite_mode "xla") against the fused kernel on the
# same draws: raintpu's own bar between its two paths
# (tests/test_pallas_batched.py:64-66). A drop's alpha is cut at
# ALPHA_CUTOFF (2e-4), and the two paths round a pixel's texture
# coordinates differently ((hx/hz + 0.5)/tw against (hx*(1/hz) + 0.5) *
# (1/tw)), so a pixel whose alpha sits within float noise of the cutoff
# can be kept by one path only. Such a pixel is a cutoff flip: the masks
# differ there by ALPHA_CUTOFF (within GOLDEN_FLIP_TOL); flips are
# counted, at most GOLDEN_MAX_FLIP_FRACTION of the pixels, and not
# compared. The sharded golden render against the unsharded one: the
# scatter's atomics add a pixel's terms in any order.
GOLDEN_ATOL = 2e-4
GOLDEN_FLIP_TOL = 1e-6
GOLDEN_MAX_FLIP_FRACTION = 1e-5
GOLDEN_SHARD_ATOL = 1e-6

# Peak rates of one H100 SXM (NVIDIA data sheet) for the bounds.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Times recorded for the kernels' first designs on an NVIDIA H100 80GB
# HBM3 at 700 W (two runs each, PERF.md section 6), printed beside this
# run's: the raster kernel on the bench rungs (K1) and on the default
# ladder's multi-tile rungs (K2), the blur on the CLI and bench stacks.
FIRST_DESIGN_MS = {"k1": "0.8985 / 0.9022", "k2": "3.0999 / 3.1023",
                   "cli fog": "0.3324 / 0.3333",
                   "bench fog": "1.8771 / 1.8890"}
# The raster kernel's previous design (row chunks of ~2,048 px a block,
# one launch per rung, zero-filled planes and global atomics), same
# card and limit, two runs each (PERF.md section 6): the bench rungs
# (K1/K3), the multi-tile rungs (K2) and the CLI batch's raster stage.
EARLIER_MS = {"k1": "0.7766 / 0.7718", "k2": "0.3410 / 0.3409",
              "cli raster": "1.119 / 1.200"}
# Other launch plans timed beside the chosen one (information).
SWEEP_RASTER_TILE_HW = ((32, 64), (16, 128), (8, 128), (16, 64), (8, 256),
                        (32, 128))
SWEEP_TILE_HW = ((32, 128), (64, 64), (64, 128), (128, 64), (32, 256))
# Raster operations per evaluated window pixel besides the DCT series
# (5 per mode and axis per rank, 2 per rank): the homography and its
# divide, 2 cos, the tanh-erf window (4 tanh and their polynomials), the
# clamp and cutoff, and the plane contributions (log included). Each
# transcendental counts as one operation.
RASTER_FIXED_OPS = 70


def phase(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    phase(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    phase(f"[device] nvidia-smi: {smi}")
    phase("[device] tf32: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build_phase() -> None:
    """Both kernels and the XML parser from the checkout's sources, one
    compiler per source, in parallel."""
    t0 = time.perf_counter()
    names = ("fused_raster", "separable_blur", "xmlparse")
    paths = cuda_build.build_all(names)
    for name in names:
        cuda_build.load(name)
    if not native.available():
        raise AssertionError("the native XML parser did not load")
    phase(f"[build] {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")


def reset_counts() -> None:
    fused_raster.fused_raster_composite.launches = 0
    fused_raster.fused_raster_composite.carried = {}
    blur_kernel.separable_blur.launches = 0


def tpu_tiles(ph: int, pw: int) -> int:
    """Row tiles of the JAX package's window plan for a (ph, pw) rung
    (fused_kernel.plan_window, f32 planes): 1 is the single-tile body
    (K1), more is the multi-tile body (K2)."""
    ph2 = -(-(ph + 8) // 8) * 8
    pw2 = -(-(pw + 128) // 128) * 128
    return max(1, -(-(ph2 * pw2) // MAX_SLAB_AREA))


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn):
    """Median CUDA-event ms of 5 calls of ``fn`` after one warm-up, each
    call timed on its own (host work between the events included)."""
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def swept_ms(module, name, values, fn, reps):
    """ms of ``fn`` with ``module.name`` set to each of ``values`` in
    turn (the launch plan reads it at call time), then restored."""
    kept = getattr(module, name)
    times = {}
    try:
        for v in values:
            setattr(module, name, v)
            times[v] = event_ms(fn, reps)
    finally:
        setattr(module, name, kept)
    return ", ".join(f"{v}{'*' if v == kept else ''}: {t:.4f}"
                     for v, t in times.items())


def bound_ms(flops: float, nbytes: float):
    """(least ms, what bounds it) from fp32 operations and bytes."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def raster_bound(rungs, image_hw, n_planes):
    """Bound of one raster call over ``rungs``: the operations of every
    window pixel inside the image of every valid slot, and the bytes of
    the operands read once and the planes written once."""
    h, w = image_hw
    ops = 0.0
    nbytes = 0
    px = 0
    for r in rungs:
        ph, pw = r.patch_hw
        c = r.params.shape[2]
        valid = (torch.arange(c, device=r.params.device)[None, :]
                 < r.n_valid[:, None])
        rows = torch.clamp(h - r.anchor[..., 1], 0, ph)
        cols = torch.clamp(w - r.anchor[..., 0], 0, pw)
        n = int((rows * cols)[valid].sum())
        ranks, my, mx = r.ayc.shape[2], r.ayc.shape[3], r.bxc.shape[3]
        ops += n * (5 * ranks * (my + mx - 2) + 2 * ranks
                    + RASTER_FIXED_OPS)
        px += n
        nbytes += sum(t.numel() * t.element_size()
                      for t in (r.params, r.anchor, r.ayc, r.bxc))
    nbytes += rungs[0].params.shape[0] * n_planes * h * w * 4
    return bound_ms(ops, nbytes) + (px,)


def tile_lists(rungs, image_hw):
    """(longest, over, blocks): the longest drop list of the ``blocks``
    blocks of a raster launch over ``rungs`` — the valid windows, clipped
    to the image, that meet the block's image tile — and the number of
    blocks whose list exceeds the kernel's capacity (drawn in rounds)."""
    h, w = image_hw
    th, tw = fused_raster.TILE_HW
    ny, nx = -(-h // th), -(-w // tw)
    b = rungs[0].n_valid.shape[0]
    dev = rungs[0].anchor.device
    diff = torch.zeros((b, ny + 1, nx + 1), dtype=torch.int64, device=dev)
    for r in rungs:
        ph, pw = r.patch_hw
        c = r.anchor.shape[1]
        ax, ay = r.anchor[..., 0].long(), r.anchor[..., 1].long()
        x1, y1 = torch.clamp(ax + pw, max=w), torch.clamp(ay + ph, max=h)
        keep = ((torch.arange(c, device=dev)[None, :] < r.n_valid[:, None])
                & (x1 > ax) & (y1 > ay))
        frame_i = torch.arange(b, device=dev)[:, None].expand(b, c)[keep]
        tx0, ty0 = ax[keep] // tw, ay[keep] // th
        tx1, ty1 = (x1[keep] - 1) // tw + 1, (y1[keep] - 1) // th + 1
        for ys, xs, sign in ((ty0, tx0, 1), (ty0, tx1, -1), (ty1, tx0, -1),
                             (ty1, tx1, 1)):
            diff.index_put_((frame_i, ys, xs),
                            torch.full_like(ys, sign), accumulate=True)
    counts = diff.cumsum(1).cumsum(2)[:, :ny, :nx]
    cap = fused_raster.LIST_CAP
    return int(counts.max()), int((counts > cap).sum()), counts.numel()


def workload_phase(dev):
    settings = RenderSettings(camera=CameraSettings())  # KITTI defaults
    cfg = frame.PipelineConfig(
        settings=settings, image_hw=(H, W), fallrate=FALLRATE,
        raster=RasterConfig(buckets=stage_profile.HAND_LADDER),
        cone_downsample=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    sim_cfg = SimConfig.from_settings(settings, capacity=SIM_CAPACITY)

    def full(v):
        return torch.full((BATCH,), float(v), dtype=torch.float32,
                          device=dev)

    drops = simulate_frames(gen, sim_cfg, full(FALLRATE), full(8.0),
                            full(settings.camera.exposure_s), full(1.0))
    drops = compact_drop_batch(drops, CAPACITY)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(BATCH, H, W, 3).astype(np.float32),
                         device=dev)
    depth = torch.as_tensor(
        (rng.rand(BATCH, H, W) * 60 + 3).astype(np.float32), device=dev)
    db = procedural_streak_database()
    tex = texture_bank(db, device=dev)
    edges = torch.as_tensor(db.bin_edges, device=dev)
    per_frame = drops.count().float()
    phase(f"[workload] {BATCH} frames {W}x{H} @ {FALLRATE:g} mm/hr; "
          f"drops per frame mean {per_frame.mean().item():.1f} "
          f"max {per_frame.max().item():.0f} (capacity {CAPACITY})")
    return cfg, gen, drops, bg, depth, tex, edges


def against_plain(tag, label, rungs, image_hw, tex_hw, n_planes):
    """The kernel against its plain version on one call over ``rungs``:
    one launch, every value within KERNEL_ATOL + KERNEL_RTOL. Returns
    the largest difference."""
    before = fused_raster.fused_raster_composite.launches
    got = fused_raster.fused_raster_composite(rungs, image_hw, tex_hw,
                                              n_planes)
    launched = fused_raster.fused_raster_composite.launches - before
    want = fused_raster.fused_raster_plain(rungs, image_hw, tex_hw,
                                           n_planes)
    torch.cuda.synchronize()
    err = (got - want).abs()
    per_plane = err.amax(dim=(0, 2, 3)).tolist()
    bad = (err > KERNEL_ATOL + KERNEL_RTOL * want.abs()).sum().item()
    drops = sum(int(r.n_valid.sum()) for r in rungs)
    phase(f"[{tag}] {label} drops {drops}: max|kernel-plain| per plane "
          f"{['%.3g' % e for e in per_plane]}, mass "
          f"{want[:, 0].sum().item():.2f}; launches {launched}")
    if bad:
        raise AssertionError(f"{tag} {label}: {bad} values off by more "
                             f"than atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}")
    if launched != 1:
        raise AssertionError(f"{tag} {label}: {launched} launches, not 1")
    return max(per_plane)


def kernel_phase(cfg, gen, drops, bg, depth, tex, edges):
    """Kernel against plain on every rung's operands of this batch, one
    rung a call (K1's use) and all rungs in one call (K3's)."""
    _, env_photo, _ = frame.frame_background(bg, depth, cfg)
    params, _ = frame.drop_fused_params(env_photo, drops, tex, edges, cfg,
                                        generator=gen)
    rungs = frame.kernel_rungs(params, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    worst = max(against_plain("kernel", f"rung {i} {rung.patch_hw}", [rung],
                              cfg.image_hw, tex_hw, 5)
                for i, rung in enumerate(rungs))
    every = against_plain("kernel", "all rungs", rungs, cfg.image_hw,
                          tex_hw, 5)
    return rungs, worst, every


def render_phase(cfg, gen, drops, bg, depth, tex, edges):
    tex_idx = select_textures(drops, edges, gen)
    reset_counts()
    out = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                              tex_idx=tex_idx)
    torch.cuda.synchronize()
    launches = fused_raster.fused_raster_composite.launches
    blur_launches = blur_kernel.separable_blur.launches
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.rainy_image, out.rain_mask))
    mass = out.rain_mask.sum().item()
    overflow = int(out.overflow.sum())
    phase(f"[render] rainy_image {tuple(out.rainy_image.shape)} finite "
          f"{finite}; mask mass {mass:.1f}; overflow {overflow}; "
          f"raster launches {launches}; blur launches {blur_launches}")
    if not finite:
        raise AssertionError("render produced non-finite values")
    if not mass > 1.0:
        raise AssertionError(f"no rain rendered (mask mass {mass})")
    if overflow:
        raise AssertionError(f"{overflow} drops overflowed their rung")
    if launches != 1:
        raise AssertionError(f"the render launched the raster kernel "
                             f"{launches} times, not once")
    if blur_launches != 1:
        raise AssertionError(f"the fog blur kernel launched {blur_launches}"
                             " times, not once per batch")

    # Reference on a small input: the first two frames rendered on the
    # CPU, where every stage runs plain PyTorch.
    sub = slice(0, 2)
    ref = frame.render_frames(
        bg[sub].cpu(), depth[sub].cpu(), drops.map(lambda t: t[sub].cpu()),
        tex.to("cpu"), edges.cpu(), cfg, tex_idx=tex_idx[sub].cpu())
    for name, got, want in (("rain_mask", out.rain_mask, ref.rain_mask),
                            ("rainy_image", out.rainy_image,
                             ref.rainy_image)):
        d = (got[sub].cpu() - want).abs()
        far = (d > RENDER_FAR).float().mean().item()
        phase(f"[render] GPU vs CPU {name} (frames 0-1): max {d.max():.3g} "
              f"mean {d.mean():.3g}; share off by > {RENDER_FAR:g}: "
              f"{far:.3g}")
        if d.max().item() > RENDER_MAX_ABS or far > RENDER_MAX_FAR_FRACTION:
            raise AssertionError(f"GPU {name} disagrees with the CPU render")
    return launches, blur_launches, tex_idx


def render_rate(render, bg, depth, drops, iters=5):
    """(images/s, s per call) of ``render(bg, depth, drops)`` over
    ``iters`` calls after a warm-up: call i moves every float input by
    i * 1e-12 (as bench.py does, so no call repeats another's inputs),
    and the host clock is read after a synchronize."""
    def once(i):
        eps = i * 1e-12
        out = render(bg + eps, depth + eps,
                     drops.map(lambda t: t + eps if t.is_floating_point()
                               else t))
        return (out.rainy_image.sum() + out.rain_mask.sum()
                + out.overflow.sum())

    once(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = torch.zeros((), device=bg.device)
    for i in range(1, iters + 1):
        acc = acc + once(i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(acc):
        raise AssertionError("timed render produced non-finite sums")
    return bg.shape[0] * iters / dt, dt / iters


def timing_phase(cfg, gen, drops, bg, depth, tex, edges, rungs, smi):
    """Images/s of the render and kernel vs plain ms (information)."""
    imgs, per = render_rate(
        lambda b, d, dr: frame.render_frames(b, d, dr, tex, edges, cfg,
                                             generator=gen), bg, depth, drops)
    phase(f"[timing] render {imgs:.2f} images/s ({per * 1e3:.1f} "
          f"ms per batch of {BATCH}) on {smi}")

    tex_hw = tuple(tex.raw.shape[1:])
    per_rung = 0.0
    for i, rung in enumerate(rungs):
        k = event_ms(lambda: fused_raster.fused_raster_composite(
            [rung], cfg.image_hw, tex_hw), 20)
        per_rung += k
        phase(f"[timing] rung {i} {rung.patch_hw}: kernel {k:.4f} ms")
    plain_ms = event_ms(lambda: fused_raster.fused_raster_plain(
        rungs, cfg.image_hw, tex_hw), 3)
    kernel_ms = event_ms(lambda: fused_raster.fused_raster_composite(
        rungs, cfg.image_hw, tex_hw), 20)
    phase(f"[timing] one launch per rung: {per_rung:.4f} ms in all")
    phase(f"[timing] all rungs in one launch: kernel {kernel_ms:.4f} ms "
          f"(first design {FIRST_DESIGN_MS['k1']}, previous design "
          f"{EARLIER_MS['k1']}), plain {plain_ms:.4f} ms, on {smi}")
    sweep = swept_ms(fused_raster, "TILE_HW", SWEEP_RASTER_TILE_HW,
                     lambda: fused_raster.fused_raster_composite(
                         rungs, cfg.image_hw, tex_hw), 20)
    phase(f"[timing] all rungs, kernel ms by image tile (* in use): {sweep}")
    return dict(ms=kernel_ms, plain_ms=plain_ms)


def library_blur(x, taps_t, r):
    """The yardstick: the same blur as PyTorch's reflect pad and two
    cuDNN convolutions (TF32 off)."""
    xp = F.pad(x[:, None], (r, r, r, r), mode="reflect")
    y = F.conv2d(xp, taps_t.view(1, 1, -1, 1))
    return F.conv2d(y, taps_t.view(1, 1, 1, -1))[:, 0]


def blur_case(tag, name, x, taps, smi):
    """The stencil blur kernel against its plain version (dense band
    matmuls) on ``x`` with ``taps``: kernel, plain, conv2d and bound ms,
    and, for the shapes of FIRST_DESIGN_MS, the kernel under other tile
    shapes."""
    r = (taps.shape[0] - 1) // 2
    shape = tuple(x.shape)
    got = blur_kernel.separable_blur(x, taps)
    want = separable_blur_hw(x, taps)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    phase(f"[{tag}] {name} {shape}, {taps.shape[0]} taps: max|kernel-plain| "
          f"{err:.3g}")
    if not err <= BLUR_ATOL:
        raise AssertionError(f"blur {name}: kernel off its plain "
                             f"version by {err} > {BLUR_ATOL}")
    ms = event_ms(lambda: blur_kernel.separable_blur(x, taps), 20)
    plain = event_ms(lambda: separable_blur_hw(x, taps), 5)
    lib = None
    if r < min(shape[1:]):
        taps_t = torch.as_tensor(taps, device=x.device)
        lib_err = (library_blur(x, taps_t, r) - want).abs().max().item()
        lib = event_ms(lambda: library_blur(x, taps_t, r), 20)
        phase(f"[{tag}] {name}: conv2d vs plain {lib_err:.3g}")
    n = x.numel()
    bnd, by = bound_ms(4 * taps.shape[0] * n, 8 * n)
    plan = blur_kernel.blur_plan(*shape, r)
    first = (f" (first design {FIRST_DESIGN_MS[name]})"
             if name in FIRST_DESIGN_MS else "")
    phase(f"[{tag}] {name}: kernel {ms:.4f} ms{first}, plain {plain:.4f}"
          f" ms, conv2d {'n/a' if lib is None else f'{lib:.4f}'} ms, "
          f"bound {bnd:.4f} ms ({by}); tile {plan.tile_h}x"
          f"{plan.tile_w}, {plan.smem_bytes} B shared; on {smi}")
    if name in FIRST_DESIGN_MS:
        sweep = swept_ms(blur_kernel, "TILE_HW", SWEEP_TILE_HW,
                         lambda: blur_kernel.separable_blur(x, taps), 20)
        phase(f"[{tag}] {name}: kernel ms by tile (* in use): {sweep}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def blur_phase(dev, smi):
    """The stencil blur kernel against its plain version on the CLI and
    bench fog stacks, an odd and a multi-fold shape."""
    taps = cv2_gaussian_kernel(fog.FOG_BLUR_KSIZE, fog.FOG_BLUR_SIGMA)
    gen = torch.Generator(device=dev).manual_seed(7)
    recs = {name: blur_case("blur", name,
                            torch.rand(shape, generator=gen, device=dev),
                            taps, smi)
            for name, shape in (("cli fog", (4 * CLI_BATCH, H, W)),
                                ("bench fog", (4 * BATCH, H, W)),
                                ("odd width", (2, 37, 333)),
                                ("multi-fold", (2, 9, 300)))}
    rec = dict(recs["cli fog"])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    return rec


def _hand_drops(dev):
    """Two near-camera Big streaks built by hand (one frame's fields):
    370 px and 200 px tall, made to land in the default ladder's
    (704, 384) and (320, 192) rungs."""
    ip1 = torch.tensor([[500.0, 0.0], [800.0, 50.0]], device=dev)
    ip2 = torch.tensor([[540.0, 370.0], [815.0, 250.0]], device=dev)
    d = ip1 - ip2
    norm = torch.sqrt((d * d).sum(-1))
    width = torch.full((2,), 12.0, device=dev)
    wp1 = torch.tensor([[0.1, 0.2, 0.6], [0.4, 0.1, 0.6]], device=dev)
    return dict(ip1=ip1, ip2=ip2, iw1=width, iw2=width, wp1=wp1,
                wp2=wp1 - torch.tensor([0.0, 0.02, 0.0], device=dev),
                max_width=width.to(torch.int32),
                length=torch.ceil(norm).to(torch.int32),
                ratio=width / norm,
                drop_type=torch.full((2,), TYPE_BIG, dtype=torch.int32,
                                     device=dev),
                valid=torch.ones(2, dtype=torch.bool, device=dev))


def multitile_phase(dev, smi):
    """The raster kernel with 8 planes against its plain version on every
    rung of the default ladder, KITTI frames at the CLI's fall rate."""
    settings = RenderSettings(camera=CameraSettings())  # KITTI defaults
    cfg = frame.PipelineConfig.build(
        settings, (H, W), CLI_FALLRATE, drop_capacity=CLI_CAPACITY,
        compute_saturation_mask=True, cone_downsample=4)
    sim_cfg = SimConfig.from_settings(settings, capacity=CLI_CAPACITY)

    def full(v):
        return torch.full((CLI_BATCH,), float(v), device=dev)

    drops = simulate_frames_keyed(
        [frame_generator(1, i, dev) for i in range(CLI_BATCH)], sim_cfg,
        full(CLI_FALLRATE), full(0.0), full(settings.camera.exposure_s),
        full(1.0))
    cap = -(-(int(drops.count().max() * 1.3) + 64) // 128) * 128
    drops = compact_drop_batch(drops, min(cap, CLI_CAPACITY))
    rng = np.random.RandomState(3)
    bg = torch.as_tensor(rng.rand(CLI_BATCH, H, W, 3).astype(np.float32),
                         device=dev)
    depth = torch.as_tensor(
        (rng.rand(CLI_BATCH, H, W) * 60 + 3).astype(np.float32), device=dev)
    db = procedural_streak_database()
    tex = texture_bank(db, device=dev)
    edges = torch.as_tensor(db.bin_edges, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tex_idx = select_textures(drops, edges, gen)

    def rungs_of(drops):
        _, env, _ = frame.frame_background(bg, depth, cfg)
        prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                          tex_idx=tex_idx)
        return frame.kernel_rungs(prep, cfg)

    rungs = rungs_of(drops)
    multi = [i for i, r in enumerate(rungs) if tpu_tiles(*r.patch_hw) > 1]
    if any(int(rungs[i].n_valid.sum()) == 0 for i in multi):
        # The last two slots of frame 0 are free after compaction.
        for name, v in _hand_drops(dev).items():
            getattr(drops, name)[0, -2:] = v
        rungs = rungs_of(drops)
        phase("[multitile] the simulated drops left a multi-tile rung "
              "empty: added 2 near-camera drops built by hand to frame 0")
    tex_hw = tuple(tex.raw.shape[1:])
    worst = 0.0
    for i, rung in enumerate(rungs):
        if i in multi and int(rung.n_valid.sum()) == 0:
            raise AssertionError(f"multi-tile rung {i} holds no drop")
        label = (f"rung {i} {rung.patch_hw} ({tpu_tiles(*rung.patch_hw)} "
                 "TPU row tiles)")
        err = against_plain("multitile", label, [rung], cfg.image_hw,
                            tex_hw, 8)
        if i in multi:
            worst = max(worst, err)
    every = against_plain("multitile", "all rungs", rungs, cfg.image_hw,
                          tex_hw, 8)
    big = [rungs[i] for i in multi]
    ms = event_ms(lambda: fused_raster.fused_raster_composite(
        big, cfg.image_hw, tex_hw, 8), 10)
    plain = event_ms(lambda: fused_raster.fused_raster_plain(
        big, cfg.image_hw, tex_hw, 8), 2)
    bnd, by, px = raster_bound(big, cfg.image_hw, 8)
    phase(f"[multitile] rungs {multi}: kernel {ms:.4f} ms (first design "
          f"{FIRST_DESIGN_MS['k2']}, previous design {EARLIER_MS['k2']}), "
          f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}; {px} window "
          f"px), on {smi}")
    sweep = swept_ms(fused_raster, "TILE_HW", SWEEP_RASTER_TILE_HW,
                     lambda: fused_raster.fused_raster_composite(
                         big, cfg.image_hw, tex_hw, 8), 10)
    phase(f"[multitile] rungs {multi}, kernel ms by image tile (* in use): "
          f"{sweep}")
    # Every slot empty: one launch over all rungs that writes zero
    # planes, beside a plain torch.zeros of the same planes.
    zero = torch.zeros_like(rungs[0].n_valid)
    empty = [dataclasses.replace(r, n_valid=zero) for r in rungs]
    if fused_raster.fused_raster_composite(empty, cfg.image_hw, tex_hw,
                                           8).any():
        raise AssertionError("an all-empty launch wrote a non-zero value")
    e_ms = event_ms(lambda: fused_raster.fused_raster_composite(
        empty, cfg.image_hw, tex_hw, 8), 10)
    fill = event_ms(lambda: torch.zeros((CLI_BATCH, 8, H, W), device=dev),
                    10)
    plan = fused_raster.tile_plan(
        cfg.image_hw, [(r.ayc.shape[2], r.ayc.shape[3], r.bxc.shape[3])
                       for r in rungs], CLI_BATCH, 8)
    phase(f"[multitile] all rungs with n_valid = 0: {e_ms:.4f} ms for "
          f"{plan.grid[0] * plan.grid[1]} blocks of {plan.tile_hw} tiles "
          f"({plan.smem_bytes} B shared); torch.zeros of the planes "
          f"{fill:.4f} ms")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                max_abs_err=worst, all_rungs_err=every, rungs=rungs,
                tex_hw=tex_hw,
                inputs=(cfg, drops, bg, depth, tex, edges, tex_idx))


def determinism_phase(bench_rungs, cli_rungs, tex_hw_bench, tex_hw_cli):
    """Two launches on the same operands give the same bits: each
    pixel's sums run in one fixed order."""
    for name, rungs, tex_hw, n_planes in (
            ("bench rungs", bench_rungs, tex_hw_bench, 5),
            ("default ladder", cli_rungs, tex_hw_cli, 8)):
        first = fused_raster.fused_raster_composite(rungs, (H, W), tex_hw,
                                                    n_planes)
        second = fused_raster.fused_raster_composite(rungs, (H, W), tex_hw,
                                                     n_planes)
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        phase(f"[determinism] {name}: two launches bit-identical {same} "
              f"(max difference {(first - second).abs().max().item():.3g})")
        if not same:
            raise AssertionError(f"two launches on the {name} differ")


def golden_compare(label, got, want, names):
    """The golden path's outputs ``got`` against the fused kernel's
    ``want`` within GOLDEN_ATOL, but for cutoff flips: pixels whose rain
    masks differ by ALPHA_CUTOFF (within GOLDEN_FLIP_TOL), at most
    GOLDEN_MAX_FLIP_FRACTION of the pixels, where the other outputs are
    not compared. Returns the largest difference outside the flips."""
    dm = (got.rain_mask - want.rain_mask).abs()
    flips = dm > GOLDEN_ATOL
    n_flips = int(flips.sum())
    odd = int((flips & ((dm - ALPHA_CUTOFF).abs() > GOLDEN_FLIP_TOL)).sum())
    worst = 0.0
    for name in names:
        d = (getattr(got, name) - getattr(want, name)).abs()
        keep = ~flips.reshape(flips.shape + (1,) * (d.ndim - flips.ndim))
        kept = torch.where(keep, d, 0.0).max().item()
        worst = max(worst, kept)
        phase(f"[golden] {label}: max|xla-fused| {name} {d.max().item():.3g}"
              f" (outside the cutoff flips {kept:.3g}); share of values "
              f"off by > {GOLDEN_ATOL:g}: "
              f"{(d > GOLDEN_ATOL).float().mean().item():.3g}")
        if kept > GOLDEN_ATOL:
            raise AssertionError(f"golden {label}: {name} off the fused "
                                 f"kernel's by {kept} > {GOLDEN_ATOL}")
    phase(f"[golden] {label}: cutoff flips {n_flips} of {dm.numel()} "
          f"pixels (mask differences {sorted(set(dm[flips].tolist()))[:4]}"
          f"...), not a flip {odd}")
    if odd or n_flips > GOLDEN_MAX_FLIP_FRACTION * dm.numel():
        raise AssertionError(f"golden {label}: {n_flips} pixels off by more "
                             f"than {GOLDEN_ATOL}, {odd} of them not a "
                             "cutoff flip")
    return worst


def golden_render(label, args, cfg, tex_idx):
    """The golden path and the fused kernel on the same inputs and
    texture picks: the golden render launches the blur once and the
    raster never; both overflow nothing and render rain."""
    fused = frame.render_frames(*args, cfg, tex_idx=tex_idx)
    xla = dataclasses.replace(cfg, composite_mode="xla")
    reset_counts()
    golden = frame.render_frames(*args, xla, tex_idx=tex_idx)
    torch.cuda.synchronize()
    launches = (fused_raster.fused_raster_composite.launches,
                blur_kernel.separable_blur.launches)
    overflow = (int(golden.overflow.sum()), int(fused.overflow.sum()))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (golden.rainy_image, golden.rain_mask))
    mass = golden.rain_mask.sum().item()
    phase(f"[golden] {label}: xla render finite {finite}, mask mass "
          f"{mass:.2f} (fused {fused.rain_mask.sum().item():.2f}); "
          f"overflow xla / fused {overflow}; raster and blur launches "
          f"during it {launches}")
    if launches != (0, 1):
        raise AssertionError(f"golden {label}: the xla render launched the "
                             f"raster and the blur {launches} times, not "
                             "(0, 1)")
    if not finite or not mass > 1.0 or overflow != (0, 0):
        raise AssertionError(f"golden {label}: finite {finite}, mass "
                             f"{mass}, overflow {overflow}")
    return golden, fused, launches


def golden_phase(data, tex_idx, b_inputs, smi):
    """The golden path (composite_mode "xla": patches, then a scatter)
    on the card: (a) A's batch against the fused kernel on the same
    texture picks, 0 raster and 1 blur launch during it; (b) B's default
    ladder with the saturation planes, the same; (c) texture_mode
    "gather" on A's frames 0-1 against the CPU; (d) the one-rank nccl
    sharded render's xla branch against render_frames' within
    GOLDEN_SHARD_ATOL; (e) images/s and peak memory of both paths on A
    (information)."""
    cfg, _, drops, bg, depth, tex, edges = data
    args = (bg, depth, drops, tex, edges)
    golden, fused, launches = golden_render("A", args, cfg, tex_idx)
    err_a = golden_compare("A", golden, fused, ("rain_mask", "rainy_image"))

    b_cfg, b_drops, b_bg, b_depth, b_tex, b_edges, b_idx = b_inputs
    got, want, _ = golden_render(
        "B", (b_bg, b_depth, b_drops, b_tex, b_edges), b_cfg, b_idx)
    err_b = golden_compare("B", got, want,
                           ("rain_mask", "rainy_image", "saturation_mask"))
    del got, want

    sub = slice(0, 2)
    gcfg = dataclasses.replace(
        cfg, composite_mode="xla", raster=dataclasses.replace(
            cfg.raster, texture_mode="gather", supersample=2))
    out = frame.render_frames(bg[sub], depth[sub], drops.map(lambda t: t[sub]),
                              tex, edges, gcfg, tex_idx=tex_idx[sub])
    mass = out.rain_mask.sum().item()
    phase(f"[golden] gather (supersample 2), A's frames 0-1: mask mass "
          f"{mass:.2f} (the series': {golden.rain_mask[sub].sum().item():.2f})")
    if not mass > 1.0:
        raise AssertionError(f"golden gather: no rain (mask mass {mass})")
    compare_with_cpu("golden gather", out,
                     cpu_render(args, gcfg, dict(tex_idx=tex_idx)),
                     ("rain_mask", "rainy_image"))

    distributed.initialize(free_address(), 1, 0, device=bg.device.type)
    try:
        mesh = pmesh.make_mesh(sp=1, device_type=bg.device.type)
        xla = dataclasses.replace(cfg, composite_mode="xla")
        reset_counts()
        sharded = pmesh.render_frames_sharded(mesh, *args, xla,
                                              tex_idx=tex_idx)
        torch.cuda.synchronize()
        s_launches = (fused_raster.fused_raster_composite.launches,
                      blur_kernel.separable_blur.launches)
    finally:
        dist.destroy_process_group()
    d_shard = max((getattr(sharded, n) - getattr(golden, n)).abs().max().item()
                  for n in ("rain_mask", "rainy_image"))
    backend = "nccl" if bg.device.type == "cuda" else "gloo"
    phase(f"[golden] sharded xla branch, one {backend} rank: max|sharded - "
          f"render_frames| {d_shard:.3g} (bar {GOLDEN_SHARD_ATOL:g}); "
          f"raster and blur launches {s_launches}")
    if d_shard > GOLDEN_SHARD_ATOL or s_launches != (0, 1) or not torch.equal(
            sharded.overflow, golden.overflow):
        raise AssertionError("the sharded xla branch disagrees with "
                             "render_frames' golden path")
    del golden, fused, sharded

    xla = dataclasses.replace(cfg, composite_mode="xla")
    rates = {}
    for name, c in (("fused", cfg), ("xla", xla), ("xla", xla),
                    ("fused", cfg)):
        rates.setdefault(name, []).append(render_rate(
            lambda b, d, dr: frame.render_frames(b, d, dr, tex, edges, c,
                                                 tex_idx=tex_idx),
            bg, depth, drops)[0])
    peak = {}
    for name, c in (("fused", cfg), ("xla", xla)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        frame.render_frames(*args, c, tex_idx=tex_idx)
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        peak[name] = f"{top / 2 ** 30:.3f} GiB ({(top - held) / 2 ** 30:.3f} "
        peak[name] += "GiB above what was held before it)"
    phase("[golden] images/s on A in turns fused / xla / xla / fused "
          f"(information): {rates['fused'][0]:.2f} / {rates['xla'][0]:.2f} "
          f"/ {rates['xla'][1]:.2f} / {rates['fused'][1]:.2f}; peak memory "
          f"of one render (max_memory_allocated) fused {peak['fused']}, "
          f"xla {peak['xla']}; on {smi}")
    phase(f"[golden] largest xla-fused difference outside the cutoff "
          f"flips: {max(err_a, err_b):.3g} (bar {GOLDEN_ATOL:g})")
    return dict(launches=launches)


def _write_dataset(root, n_frames=CLI_FRAMES):
    """A customdb dataset of n_frames KITTI-size frames: .npy RGB
    (uint8) and depth in metres, sequence 'drive'; no particle file."""
    rng = np.random.RandomState(5)
    seq = os.path.join(root, "source", "customdb", "drive")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub))
    yy = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None]
    for i in range(n_frames):
        img = np.clip(rng.rand(H, W, 3) * 0.5 + 0.4 * yy[..., None], 0, 1)
        np.save(os.path.join(seq, "rgb", f"{i:06d}.npy"),
                (img * 255).astype(np.uint8))
        depth = (3.0 + 80.0 * (1.0 - yy) + rng.rand(H, W) * 2.0)
        np.save(os.path.join(seq, "depth", f"{i:06d}.npy"),
                depth.astype(np.float32))


def launch_kinds(carried):
    """Launches that carried K1's windows (single-tile in the JAX
    package's plan), K2's (multi-tile), and all rungs at once (K3)."""
    k1 = sum(n for hws, n in carried.items()
             if any(tpu_tiles(*hw) == 1 for hw in hws))
    k2 = sum(n for hws, n in carried.items()
             if any(tpu_tiles(*hw) > 1 for hw in hws))
    k3 = sum(n for hws, n in carried.items() if len(hws) > 1)
    return k1, k2, k3


def run_cli(argv):
    """``cli.main(argv)`` with the counts set to 0 just before: returns
    the rc, the job's stats, the first render_frames call (args, kwargs,
    output), the raster launches, the windows they carried, the blur
    launches and the wall time."""
    first, stats = {}, {}
    render_frames, run = pipeline.render_frames, pipeline.RenderJob.run

    def record_render(*args, **kw):
        out = render_frames(*args, **kw)
        first.setdefault("call", (args, kw, out))
        return out

    def record_run(self):
        stats.update(run(self))
        return stats

    pipeline.render_frames = record_render
    pipeline.RenderJob.run = record_run
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_raster.fused_raster_composite.launches
        carried = dict(fused_raster.fused_raster_composite.carried)
        blur_launches = blur_kernel.separable_blur.launches
    finally:
        pipeline.render_frames = render_frames
        pipeline.RenderJob.run = run
    return rc, stats, first.get("call"), launches, carried, blur_launches, wall


def check_cli_run(tag, rc, stats, launches, carried, blur_launches,
                  n_frames, n_batch):
    """rc 0, every frame rendered, no overflow, one raster launch
    carrying every rung and one blur launch per batch."""
    k1, k2, k3 = launch_kinds(carried)
    if rc != 0 or stats.get("rendered") != n_frames:
        raise AssertionError(f"{tag}: the CLI rendered "
                             f"{stats.get('rendered')} of {n_frames} frames")
    if stats.get("overflowed_drops") != 0:
        raise AssertionError(f"{tag}: drops overflowed their rung")
    n_batches = -(-n_frames // n_batch)
    if not (launches == k3 == blur_launches == n_batches
            and k1 + k2 >= n_batches):
        raise AssertionError(
            f"{tag}: launches raster {launches} (K1 {k1}, K2 {k2}, K3 {k3}),"
            f" K4 {blur_launches}; want {n_batches} raster and blur "
            "launches, each raster launch carrying every rung")
    return dict(k1=k1, k2=k2, k3=k3, k4=blur_launches)


def check_outputs(tag, out_root, fallrate, n_frames, sat_env=True):
    """Every frame's outputs on disk; rain in every frame."""
    names = [f"{i:06d}.npy" for i in range(n_frames)]
    rain = os.path.join(out_root, "customdb", "drive", "rain",
                        f"{fallrate}mm")
    subs = ("rainy_image", "rain_mask") + (("saturation_mask",)
                                           if sat_env else ())
    for sub in subs:
        if sorted(os.listdir(os.path.join(rain, sub))) != names:
            raise AssertionError(f"{tag}: missing {sub} outputs")
    if sat_env:
        envs = os.path.join(out_root, "customdb", "drive", "envmap")
        if sorted(os.listdir(envs)) != names:
            raise AssertionError(f"{tag}: missing envmap outputs")
    masses = [float(np.load(os.path.join(rain, "rain_mask", n)).sum())
              for n in names]
    phase(f"[{tag}] mask mass per frame min {min(masses):.2f} max "
          f"{max(masses):.2f}")
    if not min(masses) > 0:
        raise AssertionError(f"{tag}: a frame rendered no rain")


def rain_outputs(out_root, fallrate):
    """{sub/name: array} of the customdb run's rainy images, rain masks
    and saturation masks at ``fallrate``."""
    rain = os.path.join(out_root, "customdb", "drive", "rain",
                        f"{fallrate}mm")
    return {f"{sub}/{name}": np.load(os.path.join(rain, sub, name))
            for sub in ("rainy_image", "rain_mask", "saturation_mask")
            for name in sorted(os.listdir(os.path.join(rain, sub)))}


def compare_with_cpu(tag, out, ref, names, frames=slice(0, 2)):
    """GPU outputs of ``frames`` against the CPU render ``ref`` of the
    same frames, within the render bars."""
    for name in names:
        d = (getattr(out, name)[frames].cpu() - getattr(ref, name)).abs()
        far = (d > RENDER_FAR).float().mean().item()
        which = (f"frame {frames.start}" if frames.stop - frames.start == 1
                 else f"frames {frames.start}-{frames.stop - 1}")
        phase(f"[{tag}] GPU vs CPU {name} ({which}): max {d.max():.3g} "
              f"mean {d.mean():.3g}; share off by > {RENDER_FAR:g}: "
              f"{far:.3g}")
        if d.max().item() > RENDER_MAX_ABS or far > RENDER_MAX_FAR_FRACTION:
            raise AssertionError(f"{tag}: GPU {name} disagrees with the "
                                 "CPU render")


def cpu_render(args, cfg, kw, frames=slice(0, 2)):
    """render_frames of ``frames`` on the CPU (every stage plain
    PyTorch), the tensor keyword arguments cut to the same frames."""
    bg, depth, drops, tex, edges = args
    kw = {k: None if v is None else v[frames].cpu() for k, v in kw.items()}
    return frame.render_frames(
        bg[frames].cpu(), depth[frames].cpu(),
        drops.map(lambda t: t[frames].cpu()), tex.to("cpu"), edges.cpu(),
        cfg, **kw)


def cli_phase(dev, smi):
    """The online CLI path on the card, end to end."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_dataset(tmp)
        out_root = os.path.join(tmp, "output")
        argv = ["--dataset", "customdb", "-k", os.path.join(tmp, "source"),
                "-d", os.path.join(tmp, "source"), "--output", out_root,
                "--online", "--intensity", str(CLI_FALLRATE),
                "--batch_size", str(CLI_BATCH), "--save_format", "npy",
                "--save_saturation", "--save_envmap",
                "--frame_end", str(CLI_FRAMES), "--noverbose",
                "--device", str(dev)]
        rc, stats, call, launches, carried, blur_launches, wall = \
            run_cli(argv)
        phase(f"[cli] rc {rc}; stats {stats}; wall {wall:.2f} s; raster "
              f"launches {launches}, by the windows each carried "
              f"{carried}; blur launches {blur_launches}")
        kinds = check_cli_run("cli", rc, stats, launches, carried,
                              blur_launches, CLI_FRAMES, CLI_BATCH)
        if not kinds["k1"] == kinds["k2"] == kinds["k3"]:
            raise AssertionError(f"the CLI path's launches {kinds}: every "
                                 "launch must carry K1's and K2's windows")
        check_outputs("cli", out_root, CLI_FALLRATE, CLI_FRAMES)
        outputs = rain_outputs(out_root, CLI_FALLRATE)

    # Frames 0-1 of the first batch against the CPU render of the same
    # drops and texture picks.
    (bg, depth, drops, tex, edges, cfg), kw, out = call
    ref = cpu_render((bg, depth, drops, tex, edges), cfg, kw)
    compare_with_cpu("cli", out, ref, ("rain_mask", "rainy_image",
                                       "saturation_mask", "envmap"))
    phase(f"[cli] img_per_s {stats.get('img_per_s')} (the job's own wall "
          f"clock, kernel builds done, disk writes included) on {smi}")
    return kinds, call, outputs


def _ladder(raster):
    return [(b.ph, b.pw, b.radius, b.capacity, b.ranks) for b in
            raster.buckets]


def offline_phase(dev, smi):
    """The offline CLI path on the card, end to end: the simulation tool
    writes the missing particle XML, the native parser reads it (and the
    .npz cache is written), the ladder is fitted to the first 8 frames,
    and every batch renders in one raster and one blur launch."""
    fits, tool_s = [], []
    fit, simulate = pipeline.fit_raster_config, \
        particles_simulation.simulate_to_xml

    def record_fit(sample, *args):
        raster = fit(sample, *args)
        fits.append((sample, args, raster))
        return raster

    def timed_tool(*args, **kw):
        t0 = time.perf_counter()
        path = simulate(*args, **kw)
        torch.cuda.synchronize()
        tool_s.append(time.perf_counter() - t0)
        return path

    parses = dict(xml_io.parse_particles_xml_raw.parses)
    with tempfile.TemporaryDirectory() as tmp:
        _write_dataset(tmp)
        out_root = os.path.join(tmp, "output")
        argv = ["--dataset", "customdb", "-k", os.path.join(tmp, "source"),
                "-d", os.path.join(tmp, "source"), "--output", out_root,
                "-r", os.path.join(tmp, "particles"),
                "--intensity", str(CLI_FALLRATE),
                "--raster_profile", "fitted",
                "--batch_size", str(CLI_BATCH), "--save_format", "npy",
                "--save_saturation", "--save_envmap",
                "--frame_end", str(CLI_FRAMES), "--noverbose",
                "--device", str(dev)]
        pipeline.fit_raster_config = record_fit
        particles_simulation.simulate_to_xml = timed_tool
        try:
            rc, stats, call, launches, carried, blur_launches, wall = \
                run_cli(argv)
        finally:
            pipeline.fit_raster_config = fit
            particles_simulation.simulate_to_xml = simulate
        native_parses = (xml_io.parse_particles_xml_raw.parses["native"]
                         - parses["native"])
        xml = os.path.join(tmp, "particles", "customdb", "drive", "rain",
                           f"{CLI_FALLRATE}mm", "0000_camera0.xml")
        phase(f"[offline] rc {rc}; stats {stats}; wall {wall:.2f} s (tool "
              f"{sum(tool_s):.2f} s); raster launches {launches}, by the "
              f"windows each carried {carried}; blur launches "
              f"{blur_launches}; native parses {native_parses}")
        if not (len(tool_s) == 1 and os.path.exists(xml)):
            raise AssertionError(f"the tool did not write {xml}")
        if native_parses != 1:
            raise AssertionError("the native parser did not read the XML")
        if not os.path.exists(xml + ".npz"):
            raise AssertionError("the .npz cache was not written")
        kinds = check_cli_run("offline", rc, stats, launches, carried,
                              blur_launches, CLI_FRAMES, CLI_BATCH)
        check_outputs("offline", out_root, CLI_FALLRATE, CLI_FRAMES)

        size = os.path.getsize(xml)
        t0 = time.perf_counter()
        streaks = xml_io.load_streaks(xml, (W, H), use_cache=False)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        xml_io.load_streaks(xml, (W, H))
        cached_s = time.perf_counter() - t0
        per_frame = np.array([len(r["ip1"]) for r in streaks.values()])
        ms = {}
        for name, native in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            frames = xml_io.parse_particles_xml_raw(xml, prefer_native=native)
            ms[name] = (time.perf_counter() - t0) * 1e3 / len(frames)
        phase(f"[offline] tool wall {tool_s[0]:.2f} s; XML {size / 1e6:.2f} "
              f"MB, {len(streaks)} frames, drops per frame (after the "
              f"in-frame cull) mean {per_frame.mean():.1f} max "
              f"{per_frame.max()}; parse ms per frame native "
              f"{ms['native']:.4f}, Python {ms['python']:.4f}; "
              f"load_streaks {load_s:.3f} s (native parse, finalize, cull)"
              f", from the .npz cache {cached_s:.3f} s")

    sample, args, raster = fits[0]
    cpu_raster = rasterize.fit_raster_config(sample.to("cpu"), *args)
    phase(f"[offline] fitted ladder (ph, pw, radius, capacity, ranks) on "
          f"the card: {_ladder(raster)}; on the CPU from the same sample: "
          f"{_ladder(cpu_raster)}")
    if cpu_raster != raster:
        card = rasterize.fit_needs(sample, *args)
        host = rasterize.fit_needs(sample.to("cpu"), *args)
        v = sample.valid.cpu()
        for name, a, b in zip(("nw", "nh", "s4"), card, host):
            d = (a.cpu() - b).abs()[v]
            phase(f"[offline] the ladders differ: {name} differs for "
                  f"{int((d > 0).sum())} of {int(v.sum())} drops "
                  f"(max {d.max().item():.3g})")
    multi = [(b.ph, b.pw) for b in raster.buckets
             if tpu_tiles(b.ph, b.pw) > 1]
    phase(f"[offline] fitted rungs multi-tile in the JAX plan (K2): "
          f"{multi or 'none'}")

    (bg, depth, drops, tex, edges, cfg), kw, out = call
    ref = cpu_render((bg, depth, drops, tex, edges), cfg, kw)
    compare_with_cpu("offline", out, ref, ("rain_mask", "rainy_image",
                                           "saturation_mask", "envmap"))
    render_ms = median_ms(lambda: frame.render_frames(
        bg, depth, drops, tex, edges, cfg, **kw))
    phase(f"[offline] render_frames of the first batch ({CLI_BATCH} "
          f"frames, capacity {drops.capacity}): {render_ms:.3f} ms, on "
          f"{smi}")
    phase(f"[offline] img_per_s {stats.get('img_per_s')} (the job's own "
          f"wall clock, the XML parse and the ladder fit included) on "
          f"{smi}")
    return kinds, call


def _pano(dev):
    """A synthetic 375x1242 panorama batch: smooth colored gradients."""
    yy = torch.linspace(0, 1, H, device=dev)[:, None]
    xx = torch.linspace(0, 1, W, device=dev)[None, :]
    one = torch.stack([0.2 + 0.7 * yy * torch.ones_like(xx),
                       0.5 + 0.4 * torch.sin(6.0 * xx) * (1 - yy),
                       0.9 - 0.6 * xx * torch.ones_like(yy)], -1)
    return one.expand(CLI_BATCH, H, W, 3).contiguous()


def regimes_phase(call, k1_ms, smi):
    """The render options on one KITTI-size batch of 8 of the offline
    run's drops: each regime's raster operands against the plain version
    and two launches bit-identical, then the regime's render on the card
    against the CPU render of frames 0-1."""
    (bg, depth, drops, tex, edges, cfg), kw, _ = call
    tex_hw = tuple(tex.raw.shape[1:])
    dev = bg.device
    gen = torch.Generator(device=dev).manual_seed(11)
    noise = torch.randn(drops.valid.shape, generator=gen, device=dev)
    regimes = {
        "fitted": ({}, {}),
        "white": ({"rendering_strategy": "white"}, {}),
        "naive_db": ({"rendering_strategy": "naive_db"}, {}),
        "noise": ({"noise_scale": 1.0, "noise_std": 1.0},
                  {"noise_deg": noise}),
        "pano": ({"env_type": "pano"}, {"pano": _pano(dev)}),
    }
    cfgs = {}
    for name, (options, _) in regimes.items():
        settings = dataclasses.replace(cfg.settings, **options)
        # Each regime's ladder fitted to its own needs, as its job would.
        cfgs[name] = dataclasses.replace(
            cfg, settings=settings, raster=rasterize.fit_raster_config(
                drops, tex_hw, cfg.image_wh, settings))
        phase(f"[regimes] {name}: ladder {_ladder(cfgs[name].raster)}")

    # The regimes' renders on the card: counts set to 0 just before.
    reset_counts()
    outs = {name: frame.render_frames(
                bg, depth, drops, tex, edges, cfgs[name],
                tex_idx=kw["tex_idx"], **extra)
            for name, (_, extra) in regimes.items() if name != "fitted"}
    torch.cuda.synchronize()
    launches = fused_raster.fused_raster_composite.launches
    carried = dict(fused_raster.fused_raster_composite.carried)
    blur_launches = blur_kernel.separable_blur.launches
    phase(f"[regimes] renders: raster launches {launches} by the windows "
          f"each carried {carried}; blur launches {blur_launches}")
    if not launches == blur_launches == len(outs):
        raise AssertionError("each regime's render must launch the raster "
                             "and the blur kernel once")
    k1, k2, k3 = launch_kinds(carried)

    worst = worst_multi = 0.0
    n_planes = N_PLANES_SAT if cfg.compute_saturation_mask else N_PLANES
    for name, (_, extra) in regimes.items():
        if name == "pano":
            continue   # the pano changes the colors, not the operands
        c = cfgs[name]
        _, env, _ = frame.frame_background(bg, depth, c)
        prep, _ = frame.drop_fused_params(env, drops, tex, edges, c,
                                          tex_idx=kw["tex_idx"],
                                          noise_deg=extra.get("noise_deg"))
        rungs = frame.kernel_rungs(prep, c)
        err = against_plain("regimes", f"{name} operands", rungs,
                            c.image_hw, tex_hw, n_planes)
        first = fused_raster.fused_raster_composite(rungs, c.image_hw,
                                                    tex_hw, n_planes)
        second = fused_raster.fused_raster_composite(rungs, c.image_hw,
                                                     tex_hw, n_planes)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"two launches on the {name} operands "
                                 "differ")
        ms = event_ms(lambda: fused_raster.fused_raster_composite(
            rungs, c.image_hw, tex_hw, n_planes), 10)
        bnd, by, px = raster_bound(rungs, c.image_hw, n_planes)
        phase(f"[regimes] {name}: two launches bit-identical; raster "
              f"{ms:.4f} ms ({n_planes} planes, batch {CLI_BATCH}; bound "
              f"{bnd:.4f} ms, {by}, {px} window px) beside the bench rungs' "
              f"{k1_ms:.4f} ms (5 planes, batch {BATCH}), on {smi}")
        worst = max(worst, err)
        if any(tpu_tiles(*r.patch_hw) > 1 for r in rungs):
            worst_multi = max(worst_multi, err)
    for name, out in outs.items():
        extra = regimes[name][1]
        ref = cpu_render((bg, depth, drops, tex, edges), cfgs[name],
                         dict(tex_idx=kw["tex_idx"], **extra))
        compare_with_cpu(f"regimes {name}", out, ref,
                         ("rain_mask", "rainy_image", "saturation_mask",
                          "envmap"))
    return dict(k1=k1, k2=k2, k3=k3, k4=blur_launches, max_abs_err=worst,
                multi_err=worst_multi)


def export_phase(dev):
    """A 4-frame online run with --export_xml (batch 2): the written XML
    re-parsed by load_streaks holds each frame's valid simulated drops."""
    jobs = []
    run = pipeline.RenderJob.run

    def keep(self):
        jobs.append(self)
        return run(self)

    with tempfile.TemporaryDirectory() as tmp:
        _write_dataset(tmp, 4)
        particles = os.path.join(tmp, "particles")
        argv = ["--dataset", "customdb", "-k", os.path.join(tmp, "source"),
                "-d", os.path.join(tmp, "source"),
                "--output", os.path.join(tmp, "output"), "-r", particles,
                "--online", "--export_xml", "--intensity", str(CLI_FALLRATE),
                "--batch_size", "2", "--save_format", "npy", "--noverbose",
                "--device", str(dev)]
        pipeline.RenderJob.run = keep
        try:
            rc = cli.main(argv)
        finally:
            pipeline.RenderJob.run = run
        xml = os.path.join(particles, "customdb", "drive", "rain",
                           f"{CLI_FALLRATE}mm", "0000_camera0.xml")
        # Read back at the simulation's own image size, as the offline
        # mode reads a KITTI-size file.
        streaks = xml_io.load_streaks(xml, jobs[0]._sim_cfg.image_wh,
                                      use_cache=False)
        got = [len(streaks[i]["ip1"]) for i in range(4)]
        want = [int(jobs[0]._drops_for_frame(i).count()) for i in range(4)]
        phase(f"[export] rc {rc}; {xml.replace(tmp, '<tmp>')} "
              f"{os.path.getsize(xml) / 1e6:.2f} MB; drops per frame read "
              f"back {got}, simulated {want}")
        if rc != 0 or got != want or not min(got) > 0:
            raise AssertionError("the exported XML does not hold each "
                                 "frame's simulated drops")


def cli_stages_phase(call, smi):
    """Stage times of one CLI batch (information): the render's stages
    on the first batch's own inputs, CUDA events, median of 5; the fog
    also with the plain dense band-matmul blur in place of the kernel; and
    the device's busy share over 3 renders under torch.profiler."""
    (bg, depth, drops, tex, edges, cfg), kw, _ = call
    tex_idx = kw["tex_idx"]
    tex_hw = tuple(tex.raw.shape[1:])
    n_planes = 8 if cfg.compute_saturation_mask else 5
    state = {}

    def fog_dense():
        kernel_blur = fog.separable_blur
        fog.separable_blur = separable_blur_hw
        try:
            return frame.batched_fog(bg, depth, cfg)
        finally:
            fog.separable_blur = kernel_blur

    def envmaps():
        _, env_photo, env_save = frame.frame_background(bg, depth, cfg)
        state["env"] = env_photo
        return env_save

    def prep():
        state["prep"] = frame.drop_fused_params(
            state["env"], drops, tex, edges, cfg, tex_idx=tex_idx)

    def raster():
        state["planes"] = fused_raster.fused_raster_composite(
            frame.kernel_rungs(state["prep"][0], cfg), cfg.image_hw, tex_hw,
            n_planes)

    def finalize():
        fogged = frame.batched_fog(bg, depth, cfg)
        return frame.finalize_frame(
            bg, fogged, frame.crop_field_planes(state["planes"], cfg), None,
            state["prep"][1], cfg)

    def render():
        return frame.render_frames(bg, depth, drops, tex, edges, cfg,
                                   tex_idx=tex_idx)

    def raster_rung(i):
        rung = frame.kernel_rungs(state["prep"][0], cfg)[i]
        return lambda: fused_raster.fused_raster_composite(
            [rung], cfg.image_hw, tex_hw, n_planes)

    stages = [("fog (blur kernel)", lambda: frame.batched_fog(bg, depth,
                                                                cfg)),
              ("fog (dense matmul blur)", fog_dense),
              ("fog + envmaps (photo, full-res)", envmaps),
              ("per-drop prep", prep),
              ("raster, one launch (K1 + K2 + K3)", raster),
              ("fog + finalize", finalize), ("render_frames", render)]
    for name, fn in stages:
        phase(f"[stages] {name}: {median_ms(fn):.3f} ms per batch of "
              f"{bg.shape[0]}")
    # The raster stage rung by rung on this batch's own drops (K1's
    # windows on the single-tile rungs, K2's on the multi-tile ones), one
    # launch a rung.
    for i, rung in enumerate(frame.kernel_rungs(state["prep"][0], cfg)):
        bnd, by, px = raster_bound([rung], cfg.image_hw, n_planes)
        kind = "K2" if tpu_tiles(*rung.patch_hw) > 1 else "K1"
        phase(f"[stages] raster rung {i} {rung.patch_hw} ({kind}): "
              f"{median_ms(raster_rung(i)):.4f} ms, drops "
              f"{int(rung.n_valid.sum())}, {px} window px, bound "
              f"{bnd:.4f} ms ({by}), on {smi}")
    bnd, by, px = raster_bound(frame.kernel_rungs(state["prep"][0], cfg),
                               cfg.image_hw, n_planes)
    phase(f"[stages] raster, all rungs: bound {bnd:.4f} ms ({by}; {px} "
          f"window px); previous design {EARLIER_MS['cli raster']} ms")
    sweep = swept_ms(fused_raster, "TILE_HW", SWEEP_RASTER_TILE_HW, raster,
                     10)
    phase(f"[stages] raster ms by image tile (* in use): {sweep}")
    busy_share("stages", render, smi)


def busy_share(tag, render, smi):
    """The device's busy share over 3 calls of ``render`` under
    torch.profiler: device kernel time over wall time."""
    render()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured (no device time in the trace)")
    phase(f"[{tag}] 3 renders: wall {wall_ms:.3f} ms, device kernel time "
          f"{device_ms:.3f} ms, device busy share {busy}, on {smi}")


def _quat_z(deg):
    """(w, x, y, z) of a rotation by ``deg`` about z."""
    half = np.deg2rad(deg) / 2.0
    return [float(np.cos(half)), 0.0, 0.0, float(np.sin(half))]


def _lidar_sweep(rng):
    """One LIDAR_TOP sweep in nuScenes' .pcd.bin layout (x, y, z,
    intensity, ring; float32): 32 beams from -30.67 to +10.67 degrees,
    NUSC_POINTS returns from the ground 1.84 m below, from obstacles
    3-70 m away on half the rays, and from 60-100 m elsewhere."""
    per_beam = NUSC_POINTS // 32
    el = np.deg2rad(np.linspace(-30.67, 10.67, 32))[:, None] + np.zeros(
        (1, per_beam))
    az = rng.uniform(0.0, 2 * np.pi, el.shape)
    ground = np.where(el < 0, 1.84 / np.sin(-np.minimum(el, -1e-3)), np.inf)
    obstacle = np.where(rng.rand(*el.shape) < 0.5,
                        rng.uniform(3.0, 70.0, el.shape), np.inf)
    r = np.minimum(ground, obstacle)
    r = np.where(np.isfinite(r), np.minimum(r, 100.0),
                 rng.uniform(60.0, 100.0, el.shape))
    scan = np.stack([r * np.cos(el) * np.sin(az), r * np.cos(el) * np.cos(az),
                     r * np.sin(el), rng.rand(*el.shape) * 100,
                     np.broadcast_to(np.arange(32.0)[:, None], el.shape)], -1)
    return scan.reshape(-1, 5).astype(np.float32)


def _write_nuscenes(root):
    """A synthetic nuScenes tree under ``root``, made from a seed: the
    v1.0-trainval tables, one scene of NUSC_FRAMES CAM_FRONT frames (one
    second at 12 Hz) saved as 1600x900 RGB .npy files (named .npy in
    sample_data, so no image codec is needed) with CAM_FRONT's and
    LIDAR_TOP's mountings, a LiDAR sweep per frame, and the ego moving
    NUSC_SPEED_MPS along x. Returns the frame names."""
    rng = np.random.RandomState(11)
    vdir = os.path.join(root, "v1.0-trainval")
    cams = os.path.join(root, "samples", "CAM_FRONT")
    sweeps = os.path.join(root, "sweeps", "LIDAR_TOP")
    for d in (vdir, cams, sweeps):
        os.makedirs(d)

    def write(name, rows):
        with open(os.path.join(vdir, name + ".json"), "w") as fh:
            json.dump(rows, fh)

    write("sensor", [
        {"token": "s_cam", "channel": "CAM_FRONT", "modality": "camera"},
        {"token": "s_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}])
    write("calibrated_sensor", [
        {"token": "cs_cam", "sensor_token": "s_cam",
         "translation": [1.70, 0.016, 1.51],
         "rotation": [0.5, -0.5, 0.5, -0.5],     # camera z = ego x
         "camera_intrinsic": [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5],
                              [0.0, 0.0, 1.0]]},
        {"token": "cs_lidar", "sensor_token": "s_lidar",
         "translation": [0.944, 0.0, 1.84], "rotation": _quat_z(-90.0),
         "camera_intrinsic": []}])
    step = NUSC_SPEED_MPS / 12.0
    write("ego_pose", [{"token": f"pose{i}",
                        "translation": [600.0 + step * i, 1600.0, 0.0],
                        "rotation": [1.0, 0.0, 0.0, 0.0]}
                       for i in range(NUSC_FRAMES)])
    write("scene", [{"token": "scene0", "first_sample_token": "sample0",
                     "name": "scene-0001"}])
    write("sample", [{"token": f"sample{i}", "scene_token": "scene0",
                      "data": {"CAM_FRONT": f"cam{i}",
                               "LIDAR_TOP": f"lidar{i}"}}
                     for i in range(NUSC_FRAMES)])
    names = [f"n008__CAM_FRONT__{1533151603512404 + 83333 * i}"
             for i in range(NUSC_FRAMES)]
    rows = []
    for i, name in enumerate(names):
        nxt = i + 1 < NUSC_FRAMES
        rows += [{"token": f"cam{i}", "sample_token": f"sample{i}",
                  "calibrated_sensor_token": "cs_cam",
                  "ego_pose_token": f"pose{i}",
                  "filename": f"samples/CAM_FRONT/{name}.npy",
                  "is_key_frame": True, "next": f"cam{i + 1}" if nxt else ""},
                 {"token": f"lidar{i}", "sample_token": f"sample{i}",
                  "calibrated_sensor_token": "cs_lidar",
                  "ego_pose_token": f"pose{i}",
                  "filename": f"sweeps/LIDAR_TOP/{name}.pcd.bin",
                  "is_key_frame": True, "next": ""}]
    write("sample_data", rows)
    h, w = NUSC_HW
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    for name in names:
        img = np.clip(rng.rand(h, w, 3) * 0.4 + 0.5 * yy + 0.05, 0, 1)
        np.save(os.path.join(cams, name + ".npy"),
                (img * 255).astype(np.uint8))
        _lidar_sweep(rng).tofile(os.path.join(sweeps, name + ".pcd.bin"))
    return names


def nuscenes_depth_phase(root, dev, smi):
    """The depth tool on the card writes every frame's map; frames 0-1
    must equal the same maps made on the CPU, bit for bit."""
    data = os.path.join(root, "source", "nuscenes")
    out = os.path.join(root, "depth", "nuscenes")
    t0 = time.perf_counter()
    n = nuscenes_depth.process(data, out, device=dev)
    torch.cuda.synchronize()
    tool_s = time.perf_counter() - t0
    if n != NUSC_FRAMES:
        raise AssertionError(f"the depth tool wrote {n} of {NUSC_FRAMES} "
                             "maps")
    ds = NuScenesCameraData(data)
    chain = ds._chain(ds.scene_tokens[0])
    for i, tok in enumerate(chain[:2]):
        name = os.path.splitext(os.path.basename(
            ds.db.get("sample_data", tok)["filename"]))[0]
        card = np.load(os.path.join(out, name + ".npy"))
        cpu = ds.dense_depth_map(tok, device="cpu").numpy()
        uv, _ = ds.project_lidar_depth(tok)
        same = np.array_equal(card, cpu)
        phase(f"[nuscenes depth] frame {i}: {len(uv)} LiDAR points in the "
              f"image, {float((card < 300).mean()):.4f} of the pixels "
              f"measured; card map equals the CPU map {same}")
        if not same:
            raise AssertionError(f"depth frame {i}: the card's map differs "
                                 "from the CPU's")
    map_ms = median_ms(lambda: ds.dense_depth_map(chain[0], device=dev))
    phase(f"[nuscenes depth] the tool: {tool_s * 1e3 / n:.2f} ms per frame "
          f"(host projection and .npy write included); dense_depth_map on "
          f"the card {map_ms:.3f} ms, on {smi}")


def check_nuscenes_outputs(out_root, scene, names):
    """Every frame's rainy image, rain mask and envmap on disk; rain in
    every frame."""
    rain = os.path.join(out_root, "nuscenes", scene, "rain",
                        f"{NUSC_FALLRATE}mm")
    want = sorted(n + ".npy" for n in names)
    for sub in (os.path.join(rain, "rainy_image"),
                os.path.join(rain, "rain_mask"),
                os.path.join(out_root, "nuscenes", scene, "envmap")):
        if sorted(os.listdir(sub)) != want:
            raise AssertionError(f"nuscenes cli: missing outputs in {sub}")
    masses = [float(np.load(os.path.join(rain, "rain_mask", n)).sum())
              for n in want]
    phase(f"[nuscenes cli] mask mass per frame min {min(masses):.2f} max "
          f"{max(masses):.2f}")
    if not min(masses) > 0:
        raise AssertionError("nuscenes cli: a frame rendered no rain")


def nuscenes_cli_phase(root, names, dev, smi):
    """The online CLI on the nuScenes tree on the card, end to end, at
    100 mm/hr with the full population: the fitted ladder, one raster and
    one blur launch per batch of 6, nothing truncated or overflowed, and
    frame 0 against the CPU render of the same drops and texture picks."""
    settings = settings_from_dict(db.settings("nuscenes"))
    capacity = stage_profile.full_population_capacity(settings,
                                                      NUSC_FALLRATE)
    out_root = os.path.join(root, "output")
    argv = ["--dataset", "nuscenes", "-k", os.path.join(root, "source"),
            "-d", os.path.join(root, "depth"), "--output", out_root,
            "--online", "--intensity", str(NUSC_FALLRATE),
            "--batch_size", str(NUSC_BATCH), "--raster_profile", "fitted",
            "--save_envmap", "--save_format", "npy",
            "--drop_capacity", str(capacity), "--noverbose",
            "--device", str(dev)]
    rc, stats, call, launches, carried, blur_launches, wall = run_cli(argv)
    phase(f"[nuscenes cli] rc {rc}; --drop_capacity {capacity}; stats "
          f"{stats}; wall {wall:.2f} s; raster launches {launches}, by the "
          f"windows each carried {carried}; blur launches {blur_launches}")
    kinds = check_cli_run("nuscenes cli", rc, stats, launches, carried,
                          blur_launches, NUSC_FRAMES, NUSC_BATCH)
    if stats.get("truncated_drops") != 0:
        raise AssertionError("nuscenes cli: the simulation capacity "
                             "truncated the population")
    check_nuscenes_outputs(out_root, "scene0", names)

    (bg, depth, drops, tex, edges, cfg), kw, out = call
    raster = cfg.raster
    multi = [(b.ph, b.pw) for b in raster.buckets
             if tpu_tiles(b.ph, b.pw) > 1]
    counts = drops.count().tolist()
    phase(f"[nuscenes cli] fitted ladder (ph, pw, radius, capacity, ranks): "
          f"{_ladder(raster)}; rungs multi-tile in the JAX plan (K2): "
          f"{multi or 'none'}; drops per frame of the first batch {counts} "
          f"(render capacity {drops.capacity})")
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                      tex_idx=kw["tex_idx"])
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    err = against_plain("nuscenes cli", "the first batch, all rungs", rungs,
                        cfg.image_hw, tex_hw, N_PLANES)
    first = fused_raster.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    second = fused_raster.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError("nuscenes cli: two launches differ")
    ms = event_ms(lambda: fused_raster.fused_raster_composite(
        rungs, cfg.image_hw, tex_hw), 10)
    bnd, by, px = raster_bound(rungs, cfg.image_hw, N_PLANES)
    longest, over, blocks = tile_lists(rungs, cfg.image_hw)
    phase(f"[nuscenes cli] two launches bit-identical; raster {ms:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}; {px} window px), {ms / bnd:.2f}x the "
          f"bound; drops per rung {[int(r.n_valid.sum()) for r in rungs]}; "
          f"longest tile list {longest} (capacity {fused_raster.LIST_CAP}; "
          f"{over} of {blocks} blocks drew in rounds), on {smi}")
    t0 = time.perf_counter()
    ref = cpu_render((bg, depth, drops, tex, edges), cfg, kw,
                     frames=slice(0, 1))
    phase(f"[nuscenes cli] the CPU render of frame 0 took "
          f"{time.perf_counter() - t0:.2f} s")
    compare_with_cpu("nuscenes cli", out, ref,
                     ("rain_mask", "rainy_image", "envmap"),
                     frames=slice(0, 1))
    render_ms = median_ms(lambda: frame.render_frames(
        bg, depth, drops, tex, edges, cfg, **kw))
    phase(f"[nuscenes cli] render_frames of the first batch ({NUSC_BATCH} "
          f"frames): {render_ms:.3f} ms; img_per_s {stats.get('img_per_s')} "
          f"(the job's own wall clock, disk to disk), on {smi}")
    multi_err = err if multi else 0.0
    return kinds, dict(max_abs_err=err, multi_err=multi_err)


def nuscenes_rig_phase(dev, smi):
    """The nuScenes 6-camera rig (stage_profile --nuscenes): stage times,
    then, on that batch's operands, the raster kernel against its plain
    version (all rungs in one launch and rung by rung), two launches
    bit-identical, raster ms against its bound, the fog's blur at
    (24, 900, 1600) and the device's busy share."""
    rec = stage_profile.main(["--nuscenes", "--json"])
    phase("[nuscenes rig] ms per step of 6 frames: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec["ms_per_step"].items()))
    phase("[nuscenes rig] deltas ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec["deltas_ms"].items()))
    w = stage_profile.workload(stage_profile.parse_args(["--nuscenes"]))
    cfg, drops, tex = w["cfg"], w["drops"], w["tex"]
    gen = torch.Generator(device=dev).manual_seed(1)
    _, env, _ = frame.frame_background(w["bg"], w["depth"], cfg)
    prep, overflow = frame.drop_fused_params(env, drops, tex, w["edges"],
                                             cfg, generator=gen)
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    counts = drops.count().tolist()
    phase(f"[nuscenes rig] simulation capacity {w['sim_capacity']}, render "
          f"capacity {w['render_capacity']}, drops per frame {counts}; "
          f"overflow {int(overflow.sum())}; fitted ladder "
          f"{_ladder(cfg.raster)}; drops per rung "
          f"{[int(r.n_valid.sum()) for r in rungs]}")
    if int(overflow.sum()):
        raise AssertionError("nuscenes rig: drops overflowed their rung")
    worst = worst_multi = 0.0
    for i, rung in enumerate(rungs):
        label = (f"rung {i} {rung.patch_hw} ({tpu_tiles(*rung.patch_hw)} TPU "
                 "row tiles)")
        err = against_plain("nuscenes rig", label, [rung], cfg.image_hw,
                            tex_hw, N_PLANES)
        worst = max(worst, err)
        if tpu_tiles(*rung.patch_hw) > 1:
            worst_multi = max(worst_multi, err)
    every = against_plain("nuscenes rig", "all rungs", rungs, cfg.image_hw,
                          tex_hw, N_PLANES)
    first = fused_raster.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    second = fused_raster.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError("nuscenes rig: two launches differ")
    ms = event_ms(lambda: fused_raster.fused_raster_composite(
        rungs, cfg.image_hw, tex_hw), 10)
    plain = event_ms(lambda: fused_raster.fused_raster_plain(
        rungs, cfg.image_hw, tex_hw), 1)
    bnd, by, px = raster_bound(rungs, cfg.image_hw, N_PLANES)
    longest, over, _ = tile_lists(rungs, cfg.image_hw)
    phase(f"[nuscenes rig] two launches bit-identical; raster, all rungs in "
          f"one launch: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}; {px} window px), {ms / bnd:.2f}x the bound; "
          f"longest tile list {longest} ({over} blocks over "
          f"{fused_raster.LIST_CAP}), on {smi}")
    taps = cv2_gaussian_kernel(fog.FOG_BLUR_KSIZE, fog.FOG_BLUR_SIGMA)
    x = torch.rand((4 * NUSC_BATCH,) + NUSC_HW, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(8))
    blur = blur_case("nuscenes rig", "rig fog", x, taps, smi)
    busy_share("nuscenes rig", lambda: frame.render_frames(
        w["bg"], w["depth"], drops, tex, w["edges"], cfg, generator=gen),
        smi)
    return dict(max_abs_err=max(worst, every), multi_err=worst_multi,
                ms=ms, plain_ms=plain, bound_ms=bnd, blur=blur)


def depth_blur_phase(root, names, dev, smi):
    """smooth_depth on one 900x1600 depth map of the nuScenes tree on the
    card: its 7-tap Gaussian is one launch of the stencil kernel, held to
    its plain version, and the whole smoothing (far planes included) to
    the same smoothing on the CPU."""
    depth = np.load(os.path.join(root, "depth", "nuscenes",
                                 names[0] + ".npy"))
    rgb = np.load(os.path.join(root, "source", "nuscenes", "samples",
                               "CAM_FRONT", names[0] + ".npy"))
    gray = (rgb.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
            ).round().astype(np.uint8)
    gray[:300] = gray[0, 0]          # a flat band: far planes to set
    reset_counts()
    got = smooth_depth.improve_depth(torch.as_tensor(gray, device=dev),
                                     torch.as_tensor(depth, device=dev),
                                     0.001, True)
    torch.cuda.synchronize()
    launches = blur_kernel.separable_blur.launches
    want = smooth_depth.improve_depth(torch.as_tensor(gray),
                                      torch.as_tensor(depth), 0.001, True)
    d = (got.cpu() - want).abs()
    bad = int((d > DEPTH_ATOL + DEPTH_RTOL * want.abs()).sum())
    phase(f"[depth blur] improve_depth {tuple(depth.shape)}: blur launches "
          f"{launches}; card vs CPU max {d.max().item():.3g} m "
          f"({bad} values off by more than atol {DEPTH_ATOL} + rtol "
          f"{DEPTH_RTOL}); far-plane pixels {int((want > 250).sum())}")
    if launches != 1 or bad:
        raise AssertionError("depth blur: improve_depth on the card must "
                             "launch the blur once and match the CPU")
    x = torch.rand((1,) + NUSC_HW, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(9))
    rec = blur_case("depth blur", "gaussian", x, cv2_gaussian_kernel(
        smooth_depth.GAUSS_KSIZE, smooth_depth.GAUSS_SIGMA), smi)
    rec["launches"] = launches
    return rec


def nuscenes_phases(dev, smi):
    """The [nuscenes] group on one synthetic tree: depth, CLI, depth
    smoothing."""
    with tempfile.TemporaryDirectory() as tmp:
        names = _write_nuscenes(os.path.join(tmp, "source", "nuscenes"))
        timed(nuscenes_depth_phase, tmp, dev, smi)
        kinds, raster = timed(nuscenes_cli_phase, tmp, names, dev, smi)
        depth = timed(depth_blur_phase, tmp, names, dev, smi)
    return kinds, raster, depth


def free_address():
    """localhost:<a free port>, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def sharded_phase(cfg, gen, drops, bg, depth, tex, edges, tex_idx, smi):
    """(a) The sharded entry in a one-rank group (nccl on a card): a
    (1, 1) mesh, the bench batch with the [render] phase's texture
    picks; the outputs must be the bits of render_frames, in one raster
    and one blur launch. Images/s of both, in turns (information)."""
    dev = bg.device
    args = (bg, depth, drops, tex, edges, cfg)
    want = frame.render_frames(*args, tex_idx=tex_idx)
    distributed.initialize(free_address(), 1, 0, device=dev.type)
    try:
        mesh = pmesh.make_mesh(sp=1, device_type=dev.type)
        reset_counts()
        got = pmesh.render_frames_sharded(mesh, *args, tex_idx=tex_idx)
        torch.cuda.synchronize()
        launches = fused_raster.fused_raster_composite.launches
        blur_launches = blur_kernel.separable_blur.launches

        def unsharded(b, d, dr):
            return frame.render_frames(b, d, dr, tex, edges, cfg,
                                       tex_idx=tex_idx)

        def sharded(b, d, dr):
            return pmesh.render_frames_sharded(mesh, b, d, dr, tex, edges,
                                               cfg, tex_idx=tex_idx)

        rates = [(name, render_rate(fn, bg, depth, drops)[0])
                 for name, fn in (("render_frames", unsharded),
                                  ("sharded", sharded), ("sharded", sharded),
                                  ("render_frames", unsharded))]
    finally:
        dist.destroy_process_group()
    names = ("rainy_image", "rain_mask", "overflow")
    equal = {n: torch.equal(getattr(got, n), getattr(want, n))
             for n in names}
    phase(f"[sharded] one rank ({'nccl' if dev.type == 'cuda' else 'gloo'}),"
          f" mesh {tuple(mesh.mesh.shape)}: torch.equal to render_frames "
          f"{equal}; raster launches {launches}, blur launches "
          f"{blur_launches}; mask mass {got.rain_mask.sum().item():.1f}")
    phase("[sharded] images/s in turns (information): "
          + ", ".join(f"{n} {r:.2f}" for n, r in rates) + f", on {smi}")
    if not all(equal.values()):
        raise AssertionError(f"the one-rank sharded render differs from "
                             f"render_frames: {equal}")
    if launches != 1 or blur_launches != 1:
        raise AssertionError(f"the one-rank sharded render launched the "
                             f"raster {launches} and the blur "
                             f"{blur_launches} times, not once each")
    return dict(launches=launches, blur_launches=blur_launches)


def _field_outputs(out):
    return {n: getattr(out, n).cpu()
            for n in ("rainy_image", "rain_mask", "overflow")}


def _pair_rank(rank, address, inputs, cfg, dev_type, out_dir):
    """One of the [sharded] phase's two ranks (its own process, on the
    parent's device, gloo): the batch as dp 1 x sp 2, the raster
    kernel against plain on this rank's operands (rank 1: the second
    half of every frame's drops), then the batch as dp 2 x sp 1; what
    it rendered and its launches go to out_dir/rank<r>.pt."""
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(address, 2, rank, device=dev.type,
                           backend="gloo")
    try:
        bg, depth, drops, tex, edges, tex_idx = (
            inputs[0].to(dev), inputs[1].to(dev), inputs[2].to(dev),
            inputs[3].to(dev), inputs[4].to(dev), inputs[5].to(dev))
        got = {}

        def render(mesh, frames, key):
            """The checked call (its outputs and launches), then the
            host ms of it and of one more call, synchronized."""
            f = slice(*frames)
            ms = []
            for _ in range(2):
                reset_counts()
                t0 = time.perf_counter()
                out = pmesh.render_frames_sharded(
                    mesh, bg[f], depth[f], drops.map(lambda t: t[f]), tex,
                    edges, cfg, tex_idx=tex_idx[f])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if not ms[1:]:
                    got[key] = _field_outputs(out)
                    got[key + "_launches"] = (
                        fused_raster.fused_raster_composite.launches,
                        blur_kernel.separable_blur.launches)
            got[key + "_ms"] = tuple(ms)

        b, n = depth.shape[0], drops.valid.shape[1]
        render(pmesh.make_mesh(sp=2, device_type=dev.type), (0, b), "sp2")
        if rank == 1:
            mine = slice(n // 2, n)
            _, env_photo, _ = frame.frame_background(bg, depth, cfg)
            params, _ = frame.drop_fused_params(
                env_photo, drops.map(lambda t: t[:, mine]), tex, edges, cfg,
                tex_idx=tex_idx[:, mine])
            got["rank1_err"] = against_plain(
                "sharded",
                f"rank 1's operands (slots {n // 2}-{n - 1} of each frame)",
                frame.kernel_rungs(params, cfg), cfg.image_hw,
                tuple(tex.raw.shape[1:]), N_PLANES)
        per = b // 2
        render(pmesh.make_mesh(sp=1, device_type=dev.type),
               (rank * per, rank * per + per), "dp2")
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def pair_phase(cfg, drops, bg, depth, tex, edges, tex_idx, smi):
    """(b) Two ranks on the one card, spawned processes with gloo (it
    takes CUDA tensors for all_reduce; NCCL refuses two ranks on one
    GPU), on the first PAIR_BATCH frames of the bench batch: dp 1 x sp 2
    within SHARD_ATOL of the one-rank render, alpha mass within
    SHARD_MASS_RTOL, the overflow summed over the ranks equal to the
    one-rank overflow, and the raster kernel against plain on rank 1's
    operands; dp 2 x sp 1 within DP_ATOL (bit-equality reported)."""
    sub = slice(0, PAIR_BATCH)
    cut = (bg[sub], depth[sub], drops.map(lambda t: t[sub]), tex, edges,
           tex_idx[sub])
    want = _field_outputs(frame.render_frames(*cut[:5], cfg,
                                              tex_idx=cut[5]))
    inputs = tuple(t.to("cpu") for t in cut)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.spawn(
            _pair_rank, args=(free_address(), inputs, cfg, bg.device.type,
                              tmp), nprocs=2, join=False)
        deadline = time.monotonic() + PAIR_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the two ranks ran over "
                                       f"{PAIR_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(2)]
    phase("[sharded] two ranks' raster and blur launches, each rank's "
          "own count (their processes; not in the kernels line): "
          + "; ".join(f"rank {r} sp2 {g['sp2_launches']} dp2 "
                      f"{g['dp2_launches']}" for r, g in enumerate(got)))
    for r, g in enumerate(got):
        if g["sp2_launches"] != (1, 1) or g["dp2_launches"] != (1, 1):
            raise AssertionError(f"rank {r}: not one raster and one blur "
                                 "launch a call")
    mass = want["rain_mask"].sum().item()
    for r, g in enumerate(got):
        out = g["sp2"]
        d_mask = (out["rain_mask"] - want["rain_mask"]).abs().max().item()
        d_img = (out["rainy_image"] - want["rainy_image"]).abs().max().item()
        rel = abs(out["rain_mask"].sum().item() - mass) / mass
        same_overflow = torch.equal(out["overflow"], want["overflow"])
        phase(f"[sharded] dp 1 x sp 2, rank {r}: max|sp2-one rank| mask "
              f"{d_mask:.3g} image {d_img:.3g}; alpha mass {mass:.2f}, "
              f"relative difference {rel:.3g}; overflow summed over the "
              f"ranks {int(out['overflow'].sum())} (one rank "
              f"{int(want['overflow'].sum())}); render ms, first call / "
              f"second: {g['sp2_ms'][0]:.1f} / {g['sp2_ms'][1]:.1f} (gloo "
              f"all-reduce through the host included), on {smi}")
        if not (d_mask <= SHARD_ATOL and d_img <= SHARD_ATOL
                and rel <= SHARD_MASS_RTOL and same_overflow):
            raise AssertionError(f"dp 1 x sp 2 rank {r} disagrees with the "
                                 "one-rank render")
    same_ranks = all(torch.equal(got[0]["sp2"][n], got[1]["sp2"][n])
                     for n in want)
    phase(f"[sharded] dp 1 x sp 2: both ranks hold the same bits "
          f"{same_ranks}")
    if not same_ranks:
        raise AssertionError("the two sp ranks finished different frames")
    per = PAIR_BATCH // 2
    diffs, bits = [], []
    for r, g in enumerate(got):
        f = slice(r * per, r * per + per)
        for n in want:
            a, b = g["dp2"][n], want[n][f]
            diffs.append((a.double() - b.double()).abs().max().item())
            bits.append(torch.equal(a, b))
    phase(f"[sharded] dp 2 x sp 1: max|dp2-one rank| {max(diffs):.3g}, "
          f"bit-equal {all(bits)}; render ms, first call / second, "
          f"rank 0 {got[0]['dp2_ms'][0]:.1f} / {got[0]['dp2_ms'][1]:.1f}, "
          f"rank 1 {got[1]['dp2_ms'][0]:.1f} / {got[1]['dp2_ms'][1]:.1f}, "
          f"for {per} frames a rank")
    if max(diffs) > DP_ATOL:
        raise AssertionError("dp 2 x sp 1 disagrees with the one-rank "
                             "render")
    return dict(max_abs_err=got[1]["rank1_err"])


def _farm(root, tmp, out_root, threads, dev, run):
    """``python -m raintpu_torch.main_threaded`` over the [cli] dataset
    in ``tmp``, its logs in tmp/logs/<run>: (wall s, {tag: the child's
    job stats}). The farm and its
    children run in a session of their own, killed whole on a time-out;
    a non-zero exit (a child failed) raises with the logs."""
    src = os.path.join(tmp, "source")
    logs = os.path.join(tmp, "logs", run)
    os.makedirs(logs)
    argv = [sys.executable, "-m", "raintpu_torch.main_threaded",
            "--dataset", "customdb", "-k", src, "-d", src,
            "--output", out_root, "--online",
            "--intensity", ",".join(map(str, FARM_INTENSITIES)),
            "--frames_per_thread", str(CLI_BATCH),
            "--frame_end", str(CLI_FRAMES), "--max_threads", str(threads),
            "--log_dir", logs, "--batch_size", str(CLI_BATCH),
            "--drop_capacity", str(CLI_CAPACITY), "--save_format", "npy",
            "--save_saturation", "--save_envmap", "--device", str(dev)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        printed = proc.communicate(timeout=FARM_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - t0
    stats = {}
    for name in sorted(os.listdir(logs)):
        if name.startswith("automate_log_"):
            with open(os.path.join(logs, name)) as fh:
                done = [ln for ln in fh if ln.startswith("Done: ")]
            stats[name[len("automate_log_"):-4]] = (
                ast.literal_eval(done[-1][len("Done: "):]) if done else None)
    if proc.returncode != 0 or len(stats) != 4 or None in stats.values():
        errs = "".join(open(os.path.join(logs, n)).read()[-2000:]
                       for n in sorted(os.listdir(logs))
                       if n.startswith("automate_error_"))
        raise AssertionError(f"the farm exited {proc.returncode}:\n"
                             f"{printed[-4000:]}\n{errs}")
    return wall, stats


def farm_phase(cli_outputs, dev, smi):
    """The render farm on the [cli] phase's dataset: 4 children (25 and
    50 mm/hr x frame windows 0-7, 8-15), one at a time and then two at a
    time, into separate output roots. Every child exits 0 and renders
    its 8 frames, every frame's outputs exist, the 25 mm/hr frames equal
    the [cli] job's within FARM_ATOL (online frames are keyed by frame
    index and the windows are [cli]'s batches), and a third run over the
    two-at-a-time outputs skips every frame and rewrites no file. Wall
    time and images/s (information). The children's kernel launches
    are in their own processes, not in the kernels line."""
    root = os.path.dirname(os.path.abspath(__file__))
    n_frames = len(FARM_INTENSITIES) * CLI_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        _write_dataset(tmp)
        runs = {}
        for threads in (1, 2):
            out_root = os.path.join(tmp, f"farm{threads}")
            wall, stats = _farm(root, tmp, out_root, threads, dev,
                                f"threads{threads}")
            runs[threads] = out_root
            rendered = [s["rendered"] for s in stats.values()]
            summed = sum(s.get("img_per_s", 0.0) for s in stats.values())
            phase(f"[farm] --max_threads {threads}: 4 children rendered "
                  f"{rendered} frames; wall {wall:.2f} s, "
                  f"{n_frames / wall:.2f} images/s over the wall, "
                  f"children's img_per_s summed "
                  f"{summed:.2f} (each its job's own wall clock), on {smi}")
            if rendered != [CLI_BATCH] * 4:
                raise AssertionError(f"farm children rendered {rendered}")
            for fallrate in FARM_INTENSITIES:
                check_outputs("farm", out_root, fallrate, CLI_FRAMES)
            got = rain_outputs(out_root, CLI_FALLRATE)
            if sorted(got) != sorted(cli_outputs):
                raise AssertionError("the farm's outputs at "
                                     f"{CLI_FALLRATE} mm/hr differ in name")
            diff = max(np.abs(got[k].astype(np.float64)
                              - cli_outputs[k].astype(np.float64)).max()
                       for k in got)
            bits = all(np.array_equal(got[k], cli_outputs[k]) for k in got)
            phase(f"[farm] {CLI_FALLRATE} mm/hr frames against the [cli] "
                  f"job: max difference {diff:.3g}, bit-equal {bits}")
            if diff > FARM_ATOL:
                raise AssertionError("the farm's frames differ from the "
                                     "single job's")
        out_root = runs[2]
        before = {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                  for d, _, fs in os.walk(out_root) for f in fs}
        wall, stats = _farm(root, tmp, out_root, 2, dev, "rerun")
        after = {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                 for d, _, fs in os.walk(out_root) for f in fs}
        skipped = [(s["rendered"], s["skipped"]) for s in stats.values()]
        phase(f"[farm] rerun over complete outputs: (rendered, skipped) "
              f"{skipped}; {len(before)} files, rewritten "
              f"{sum(after[k] != before[k] for k in before)}; wall "
              f"{wall:.2f} s")
        if skipped != [(0, CLI_BATCH)] * 4 or after != before:
            raise AssertionError("the farm's rerun did not skip everything")


def timed(fn, *args):
    """fn(*args), its wall time printed after it."""
    t0 = time.perf_counter()
    out = fn(*args)
    phase(f"[time] {fn.__name__}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> None:
    t_start = time.perf_counter()
    smi = timed(device_phase)
    timed(build_phase)
    dev = torch.device("cuda", 0)
    data = timed(workload_phase, dev)
    rungs, max_err, all_err = timed(kernel_phase, *data)
    launches, blur_launches, tex_idx = timed(render_phase, *data)
    k1 = timed(timing_phase, *data, rungs, smi)
    k1_bound, k1_by, k1_px = raster_bound(rungs, (H, W), 5)
    phase(f"[timing] all rungs: bound {k1_bound:.4f} ms ({k1_by}; {k1_px} "
          "window px)")
    sharded = timed(sharded_phase, *data, tex_idx, smi)
    cfg, _, drops, bg, depth, tex, edges = data
    pair = timed(pair_phase, cfg, drops, bg, depth, tex, edges, tex_idx, smi)
    blur = timed(blur_phase, dev, smi)
    k2 = timed(multitile_phase, dev, smi)
    timed(determinism_phase, rungs, k2["rungs"],
          tuple(data[5].raw.shape[1:]), k2["tex_hw"])
    golden = timed(golden_phase, data, tex_idx, k2.pop("inputs"), smi)
    cli_launches, cli_call, cli_outputs = timed(cli_phase, dev, smi)
    timed(farm_phase, cli_outputs, dev, smi)
    timed(cli_stages_phase, cli_call, smi)
    offline_launches, offline_call = timed(offline_phase, dev, smi)
    regimes = timed(regimes_phase, offline_call, k1["ms"], smi)
    timed(export_phase, dev)
    nusc, nusc_raster, depth = nuscenes_phases(dev, smi)
    rig = timed(nuscenes_rig_phase, dev, smi)
    phase(f"[time] all phases: {time.perf_counter() - t_start:.2f} s")
    raster = dict(name="fused_raster", route="cuda", source=KERNEL_SOURCE,
                  plain_ms=k1["plain_ms"], bound_ms=k1_bound,
                  bound_by=k1_by, library_ms=None)

    def by_path(kind, bench, one_rank, golden_launches, **more):
        """Launches of the bench render, the online CLI run, the offline
        CLI run, the regimes' renders, the nuScenes CLI run, the
        one-rank sharded render and the golden render of A that carried
        ``kind`` (and ``more``), and their sum."""
        paths = {"bench": bench, "cli": cli_launches[kind],
                 "offline": offline_launches[kind],
                 "regimes": regimes[kind], "nuscenes": nusc[kind],
                 "sharded": one_rank, "golden": golden_launches, **more}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    # K1 and K3 are one launch of the same kernel on the bench path (K1's
    # windows, all rungs at once); their time is that launch's.
    print(f"[device] nvidia-smi: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {**raster, "replaces": KERNEL_REPLACES,
         **by_path("k1", launches, sharded["launches"],
                   golden["launches"][0]),
         "max_abs_err": max(max_err, regimes["max_abs_err"],
                            rig["max_abs_err"], nusc_raster["max_abs_err"],
                            pair["max_abs_err"]),
         "ms": k1["ms"]},
        {**raster, "name": "fused_raster_multitile",
         "replaces": K2_REPLACES, **by_path("k2", 0, 0, 0),
         "max_abs_err": max(k2["max_abs_err"], regimes["multi_err"],
                            rig["multi_err"], nusc_raster["multi_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"]},
        {**raster, "name": "fused_raster_resident",
         "replaces": K3_REPLACES,
         **by_path("k3", launches, sharded["launches"],
                   golden["launches"][0]),
         "max_abs_err": max(all_err, k2["all_rungs_err"],
                            regimes["max_abs_err"], rig["max_abs_err"],
                            nusc_raster["max_abs_err"], pair["max_abs_err"]),
         "ms": k1["ms"]},
        {"name": "separable_blur", "route": "cuda", "source": BLUR_SOURCE,
         "replaces": BLUR_REPLACES,
         **by_path("k4", blur_launches, sharded["blur_launches"],
                   golden["launches"][1], depth=depth["launches"]),
         **blur, "max_abs_err": max(blur["max_abs_err"],
                                    rig["blur"]["max_abs_err"],
                                    depth["max_abs_err"])}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
