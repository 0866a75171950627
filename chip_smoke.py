"""Smoke run of the PyTorch port (raintpu_torch) on one NVIDIA GPU.

Drives the port's two paths and checks them. The benchmark workload —
KITTI 1242x375 at 10 mm/hr, batch 48, drops simulated on the card and
packed to capacity 320, the four-rung hand ladder, cone_downsample 4
with env_fold, five float32 planes — and the online CLI path
(``raintpu_torch.cli.main``) on a 16-frame KITTI-size customdb dataset
with the default ladder, the saturation mask and the envmap. Phases:

  1. device: a CUDA card is required; prints its name, its
     ``nvidia-smi`` name and power limit, and the TF32 flags (off);
  2. build: compiles both CUDA kernels from raintpu_torch/csrc/ (one
     nvcc per source, in parallel);
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
  7. blur: the fog stage's stencil kernel against its plain version on
     the CLI and bench fog stacks, odd and multi-fold shapes, with
     kernel, plain, conv2d and bound ms, and the kernel under other tile
     shapes;
  8. multitile: the raster kernel with 8 planes on every rung of the
     default ladder at KITTI size, the multi-tile rungs included, one
     rung a call and all rungs in one call, timed under several image
     tiles, and one launch with every slot empty against a plain
     ``torch.zeros`` of the same planes;
  9. determinism: two launches on the bench rungs and on the default
     ladder's rungs give the same bits;
 10. cli: ``cli.main`` renders the dataset on the card; outputs, one
     raster launch per batch carrying every rung, and the first two
     frames against the CPU render of the same drops and texture picks;
 11. stages: stage times of one CLI batch, the raster stage rung by rung.

Each kernel time is printed beside the one recorded for the kernel's
first design (one block per drop for the raster kernel, 32x128 tiles
with one shared load per tap for the blur) and, for the raster kernel,
its previous design's (row chunks, one launch per rung; PERF.md section
6).

Prints a kernels JSON line, then ``{"ok": true, "device": ...}`` as the
last line. Any failing phase raises and the script exits non-zero.

Run from the repository root:  python3 chip_smoke.py
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from raintpu_torch import cli, cuda_build
from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import blur_kernel, fog, fused_raster
from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur_hw
from raintpu_torch.ops.rasterize import (BucketSpec, RasterConfig,
                                         select_textures)
from raintpu_torch.particles.schema import TYPE_BIG, compact_drop_batch
from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                             simulate_frames,
                                             simulate_frames_keyed)
from raintpu_torch.render import frame, pipeline
from raintpu_torch.render.camera import CameraSettings, RenderSettings

H, W = 375, 1242
BATCH = 48
FALLRATE = 10.0
CAPACITY = 320
SIM_CAPACITY = 512
# The benchmark's hand ladder (ph, pw, radius, capacity, modes_y,
# modes_x, ranks), as bench.py runs it.
LADDER = (BucketSpec(24, 32, 5, 224, 12, 6, 3),
          BucketSpec(48, 32, 8, 64, 12, 6, 3),
          BucketSpec(96, 64, 12, 32, 24, 10, 4),
          BucketSpec(112, 96, 20, 16, 16, 8, 4))
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
    t0 = time.perf_counter()
    names = ("fused_raster", "separable_blur")
    paths = cuda_build.build_all(names)
    for name in names:
        cuda_build.load(name)
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


def workload_phase(dev):
    settings = RenderSettings(camera=CameraSettings())  # KITTI defaults
    cfg = frame.PipelineConfig(
        settings=settings, image_hw=(H, W), fallrate=FALLRATE,
        raster=RasterConfig(buckets=LADDER, modal_blur=True),
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
    return launches, blur_launches


def timing_phase(cfg, gen, drops, bg, depth, tex, edges, rungs, smi):
    """Images/s of the render and kernel vs plain ms (information)."""
    iters = 5

    def render_once(i):
        eps = i * 1e-12
        d_i = drops.map(lambda t: t + eps if t.is_floating_point() else t)
        out = frame.render_frames(bg + eps, depth + eps, d_i, tex, edges,
                                  cfg, generator=gen)
        return (out.rainy_image.sum() + out.rain_mask.sum()
                + out.overflow.sum())

    render_once(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = torch.zeros((), device=bg.device)
    for i in range(1, iters + 1):
        acc = acc + render_once(i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(acc):
        raise AssertionError("timed render produced non-finite sums")
    imgs = BATCH * iters / dt
    phase(f"[timing] render {imgs:.2f} images/s ({dt / iters * 1e3:.1f} "
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


def blur_phase(dev, smi):
    """The stencil blur kernel against its plain version (dense band
    matmuls) on the CLI and bench fog stacks and a multi-fold shape."""
    taps = cv2_gaussian_kernel(fog.FOG_BLUR_KSIZE, fog.FOG_BLUR_SIGMA)
    r = (taps.shape[0] - 1) // 2
    taps_t = torch.as_tensor(taps, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    worst, rec = 0.0, None
    for name, shape in (("cli fog", (4 * CLI_BATCH, H, W)),
                        ("bench fog", (4 * BATCH, H, W)),
                        ("odd width", (2, 37, 333)),
                        ("multi-fold", (2, 9, 300))):
        x = torch.rand(shape, generator=gen, device=dev)
        got = blur_kernel.separable_blur(x, taps)
        want = separable_blur_hw(x, taps)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        phase(f"[blur] {name} {shape}: max|kernel-plain| {err:.3g}")
        if not err <= BLUR_ATOL:
            raise AssertionError(f"blur {name}: kernel off its plain "
                                 f"version by {err} > {BLUR_ATOL}")
        worst = max(worst, err)
        ms = event_ms(lambda: blur_kernel.separable_blur(x, taps), 20)
        plain = event_ms(lambda: separable_blur_hw(x, taps), 5)
        lib = None
        if r < min(shape[1:]):
            lib_err = (library_blur(x, taps_t, r) - want).abs().max().item()
            lib = event_ms(lambda: library_blur(x, taps_t, r), 20)
            phase(f"[blur] {name}: conv2d vs plain {lib_err:.3g}")
        n = x.numel()
        bnd, by = bound_ms(4 * taps.shape[0] * n, 8 * n)
        plan = blur_kernel.blur_plan(*shape, r)
        first = (f" (first design {FIRST_DESIGN_MS[name]})"
                 if name in FIRST_DESIGN_MS else "")
        phase(f"[blur] {name}: kernel {ms:.4f} ms{first}, plain {plain:.4f}"
              f" ms, conv2d {'n/a' if lib is None else f'{lib:.4f}'} ms, "
              f"bound {bnd:.4f} ms ({by}); tile {plan.tile_h}x"
              f"{plan.tile_w}, {plan.smem_bytes} B shared; on {smi}")
        if name in FIRST_DESIGN_MS:
            sweep = swept_ms(blur_kernel, "TILE_HW", SWEEP_TILE_HW,
                             lambda: blur_kernel.separable_blur(x, taps), 20)
            phase(f"[blur] {name}: kernel ms by tile (* in use): {sweep}")
        if name == "cli fog":
            rec = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
    rec["max_abs_err"] = worst
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
                tex_hw=tex_hw)


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


def _write_dataset(root):
    """A customdb dataset of CLI_FRAMES KITTI-size frames: .npy RGB
    (uint8) and depth in metres, sequence 'drive'."""
    rng = np.random.RandomState(5)
    seq = os.path.join(root, "source", "customdb", "drive")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub))
    yy = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None]
    for i in range(CLI_FRAMES):
        img = np.clip(rng.rand(H, W, 3) * 0.5 + 0.4 * yy[..., None], 0, 1)
        np.save(os.path.join(seq, "rgb", f"{i:06d}.npy"),
                (img * 255).astype(np.uint8))
        depth = (3.0 + 80.0 * (1.0 - yy) + rng.rand(H, W) * 2.0)
        np.save(os.path.join(seq, "depth", f"{i:06d}.npy"),
                depth.astype(np.float32))


def cli_phase(dev, smi):
    """The online CLI path on the card, end to end."""
    first, stats = {}, {}
    render_frames, run = pipeline.render_frames, pipeline.RenderJob.run

    def record_render(*args, **kw):
        out = render_frames(*args, **kw)
        first.setdefault("call", (args, kw, out))
        return out

    def record_run(self):
        stats.update(run(self))
        return stats

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
        # Launches that carried K1's windows (single-tile in the JAX
        # package's plan), K2's (multi-tile), and all rungs at once (K3).
        k1 = sum(n for hws, n in carried.items()
                 if any(tpu_tiles(*hw) == 1 for hw in hws))
        k2 = sum(n for hws, n in carried.items()
                 if any(tpu_tiles(*hw) > 1 for hw in hws))
        k3 = sum(n for hws, n in carried.items() if len(hws) > 1)
        n_batches = -(-CLI_FRAMES // CLI_BATCH)
        phase(f"[cli] rc {rc}; stats {stats}; wall {wall:.2f} s; raster "
              f"launches {launches}, by the windows each carried "
              f"{carried}; blur launches {blur_launches}")
        if rc != 0 or stats.get("rendered") != CLI_FRAMES:
            raise AssertionError(f"the CLI rendered {stats.get('rendered')}"
                                 f" of {CLI_FRAMES} frames")
        if stats.get("overflowed_drops") != 0:
            raise AssertionError("drops overflowed their rung in the CLI")
        if not (launches == k1 == k2 == k3 == blur_launches == n_batches):
            raise AssertionError(
                f"the CLI path's launches: raster {launches} (K1 {k1}, K2 "
                f"{k2}, K3 {k3}), K4 {blur_launches}; want {n_batches} each")
        names = [f"{i:06d}.npy" for i in range(CLI_FRAMES)]
        rain = os.path.join(out_root, "customdb", "drive", "rain",
                            f"{CLI_FALLRATE}mm")
        for sub in ("rainy_image", "rain_mask", "saturation_mask"):
            if sorted(os.listdir(os.path.join(rain, sub))) != names:
                raise AssertionError(f"missing {sub} outputs")
        envs = os.path.join(out_root, "customdb", "drive", "envmap")
        if sorted(os.listdir(envs)) != names:
            raise AssertionError("missing envmap outputs")
        masses = [float(np.load(os.path.join(rain, "rain_mask", n)).sum())
                  for n in names]
        sats = [float(np.load(os.path.join(rain, "saturation_mask",
                                           n)).astype(np.float64).sum())
                for n in names]
        phase(f"[cli] mask mass per frame min {min(masses):.2f} max "
              f"{max(masses):.2f}; saturation (uint8 sum) min {min(sats)}")
        if not min(masses) > 0:
            raise AssertionError("a frame rendered no rain")

    # Frames 0-1 of the first batch against the CPU render of the same
    # drops and texture picks.
    (bg, depth, drops, tex, edges, cfg), kw, out = first["call"]
    sub = slice(0, 2)
    ref = frame.render_frames(
        bg[sub].cpu(), depth[sub].cpu(), drops.map(lambda t: t[sub].cpu()),
        tex.to("cpu"), edges.cpu(), cfg, tex_idx=kw["tex_idx"][sub].cpu())
    for name in ("rain_mask", "rainy_image", "saturation_mask", "envmap"):
        d = (getattr(out, name)[sub].cpu() - getattr(ref, name)).abs()
        far = (d > RENDER_FAR).float().mean().item()
        phase(f"[cli] GPU vs CPU {name} (frames 0-1): max {d.max():.3g} "
              f"mean {d.mean():.3g}; share off by > {RENDER_FAR:g}: "
              f"{far:.3g}")
        if d.max().item() > RENDER_MAX_ABS or far > RENDER_MAX_FAR_FRACTION:
            raise AssertionError(f"GPU {name} disagrees with the CPU render")
    phase(f"[cli] img_per_s {stats.get('img_per_s')} (the job's own wall "
          f"clock, kernel builds done, disk writes included) on {smi}")
    return dict(k1=k1, k2=k2, k3=k3, k4=blur_launches), first["call"]


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

    def median_ms(fn):
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
    phase(f"[stages] 3 renders: wall {wall_ms:.3f} ms, device kernel time "
          f"{device_ms:.3f} ms, device busy share {busy}, on {smi}")


def main() -> None:
    smi = device_phase()
    build_phase()
    dev = torch.device("cuda", 0)
    data = workload_phase(dev)
    rungs, max_err, all_err = kernel_phase(*data)
    launches, blur_launches = render_phase(*data)
    k1 = timing_phase(*data, rungs, smi)
    k1_bound, k1_by, k1_px = raster_bound(rungs, (H, W), 5)
    phase(f"[timing] all rungs: bound {k1_bound:.4f} ms ({k1_by}; {k1_px} "
          "window px)")
    blur = blur_phase(dev, smi)
    k2 = multitile_phase(dev, smi)
    determinism_phase(rungs, k2["rungs"], tuple(data[5].raw.shape[1:]),
                      k2["tex_hw"])
    cli_launches, cli_call = cli_phase(dev, smi)
    cli_stages_phase(cli_call, smi)
    raster = dict(name="fused_raster", route="cuda", source=KERNEL_SOURCE,
                  plain_ms=k1["plain_ms"], bound_ms=k1_bound,
                  bound_by=k1_by, library_ms=None)

    def by_path(bench, cli_run):
        """Launches of the bench render and of the CLI run, and their
        sum."""
        return {"launches": bench + cli_run,
                "launches_by_path": {"bench": bench, "cli": cli_run}}

    # K1 and K3 are one launch of the same kernel on the bench path (K1's
    # windows, all rungs at once); their time is that launch's.
    print(f"[device] nvidia-smi: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {**raster, "replaces": KERNEL_REPLACES,
         **by_path(launches, cli_launches["k1"]), "max_abs_err": max_err,
         "ms": k1["ms"]},
        {**raster, "name": "fused_raster_multitile",
         "replaces": K2_REPLACES, **by_path(0, cli_launches["k2"]),
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"]},
        {**raster, "name": "fused_raster_resident",
         "replaces": K3_REPLACES, **by_path(launches, cli_launches["k3"]),
         "max_abs_err": max(all_err, k2["all_rungs_err"]), "ms": k1["ms"]},
        {"name": "separable_blur", "route": "cuda", "source": BLUR_SOURCE,
         "replaces": BLUR_REPLACES,
         **by_path(blur_launches, cli_launches["k4"]), **blur}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
