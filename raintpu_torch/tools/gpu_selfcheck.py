"""GPU self-check: the card's kernels against the plain path, in one
command (the port's ``raintpu.tools.tpu_selfcheck``).

Renders one small two-population scene twice from the same drops and
texture picks — on the card, through the raster and blur kernels, and
on the CPU, where every stage is plain PyTorch — and holds:

- the raster kernel against ``fused_raster_plain`` on the scene's
  rungs (each rung alone and all in one launch) within KERNEL_ATOL +
  KERNEL_RTOL * |plain|;
- the two renders' rain mask and image within the render bars:
  RENDER_MAX_ABS at most, and at most RENDER_MAX_FAR_FRACTION of the
  values off by more than RENDER_FAR;
- rain on both sides (mask mass > 1);
- the fog on the card (``ops/fog.fog_rain_layer``, the blur kernel) at
  KITTI's 375x1242 against a float64 host oracle within FOG_F64_BOUND.

Frame 0 is the standard mix; the last frame is a near-field population
(z <= 2 m, focal 500 px, 60 mm/hr) of Big perspective drops whose
canvas bands the image clips, with the heaviest blur, so that the check
covers every class of the kernel's parameters.

The JAX tool allowed 5e-2 between the TPU and interpret mode for the
TPU's transcendental lowerings. The port holds the tighter bars it has
held since its first slice, which the card tests import
(``tests/test_torch_gpu.py``): the kernel is built with --fmad=false and
rounds as the plain version does. The JAX tool's
``kernel_modes_ok`` gate is not ported: the port has no kernel modes.

Run on a machine with a CUDA card:  python -m raintpu_torch.tools.gpu_selfcheck
Prints one JSON line, then "GPU self-check PASSED"; exits nonzero when a
check fails or no card is present.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from raintpu_torch import resolve_device
from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import fog as fog_ops
from raintpu_torch.ops import fused_raster
from raintpu_torch.ops.blur import _blur_matrix, cv2_gaussian_kernel
from raintpu_torch.ops.rasterize import (BucketSpec, RasterConfig,
                                         select_textures)
from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                             simulate_frames_keyed,
                                             stack_batches)
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings

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
# footprint (~100 px). Measured on an H100 (two KITTI frames, 931,500
# mask pixels): max 1.9e-3, mean 9e-8, 1.4e-4 of the pixels off by
# > 2e-4. So: a bound on the largest difference such a flip can give,
# and room for about nine flipped streaks of the ~470 in two frames.
RENDER_MAX_ABS = 5e-3
RENDER_FAR = 2e-4
RENDER_MAX_FAR_FRACTION = 1e-3
# The fog against the float64 oracle: the module's contract, as the JAX
# tool's (which allowed the TPU's bf16 matmul passes).
FOG_F64_BOUND = 5e-3
# Seeds of the scene's draws: the simulation of frames 0..B-2 and of the
# near-field frame (frame_generator(seed, frame)), and the texture picks
# (frame b's generator seeded PICK_SEED * 100003 + b, as the render job
# keys them).
SIM_SEED, CLOSE_SEED, PICK_SEED = 1, 7, 2


def build_scene(B=2, H=96, W=256, fallrate=100.0, capacity=64,
                device=None):
    """The self-check scene on ``device`` (None: the card), its
    parameters field for field the JAX tool's. Returns (cfg, (bg,
    depth, drops, tex, edges, tex_idx)): tex_idx (B, N) is every drop's
    texture pick, data that every render of the scene takes."""
    dev = resolve_device(device)
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H)))
    raster = RasterConfig(buckets=(
        BucketSpec(40, 32, 5, capacity, 16, 8),
        BucketSpec(96, 64, 12, max(8, capacity // 2), 24, 10),
    ))
    cfg = frame.PipelineConfig(settings=settings, image_hw=(H, W),
                               fallrate=fallrate, raster=raster,
                               env_downsample=4, composite_mode="fused")

    def full(n, v):
        return torch.full((n,), float(v), dtype=torch.float32, device=dev)

    # Frame 0.. = the standard mix; the last frame = a near-field
    # population (z <= 2 m) with Big perspective drops, image-clipped
    # canvas bands and the heaviest blur.
    sim_cfg = SimConfig(image_wh=(W, H), focal_px=(300.0, 300.0),
                        exposure_s=2e-3, capacity=capacity, z_max=6.0)
    n_std = B - 1 if B >= 2 else B
    parts = [simulate_frames_keyed(
        [frame_generator(SIM_SEED, b, dev) for b in range(n_std)], sim_cfg,
        full(n_std, fallrate), full(n_std, 5.0), full(n_std, 2e-3),
        full(n_std, 1.0))]
    if B >= 2:
        sim_close = SimConfig(image_wh=(W, H), focal_px=(500.0, 500.0),
                              exposure_s=2e-3, capacity=capacity,
                              z_max=2.0)
        parts.append(simulate_frames_keyed(
            [frame_generator(CLOSE_SEED, 0, dev)], sim_close, full(1, 60.0),
            full(1, 6.0), full(1, 2e-3), full(1, 1.0)))
    drops = stack_batches(parts)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(B, H, W, 3).astype(np.float32),
                         device=dev)
    depth = torch.as_tensor((rng.rand(B, H, W) * 40 + 3).astype(np.float32),
                            device=dev)
    db = procedural_streak_database()
    tex = texture_bank(db, device=dev)
    edges = torch.as_tensor(db.bin_edges, device=dev)
    tex_idx = torch.stack([
        select_textures(drops.map(lambda t: t[b]), edges,
                        torch.Generator(device=dev).manual_seed(
                            PICK_SEED * 100003 + b))
        for b in range(B)])
    return cfg, (bg, depth, drops, tex, edges, tex_idx)


def fog_f64_oracle(img: np.ndarray, depth: np.ndarray,
                   rain_intensity: float = 10.0, f_number: float = 6.0,
                   exposure_s: float = 2e-3,
                   camera_gain: float = 20.0) -> np.ndarray:
    """The fog of one (H, W, 3) frame in float64 on the host: the same
    model and REFLECT_101 truncated Gaussian (through the band matrices)
    as ``ops/fog.fog_rain_layer``, at independent precision."""
    i64, d64 = img.astype(np.float64), depth.astype(np.float64)
    h, w = d64.shape
    f_ext = np.exp(-fog_ops.beta_ext(rain_intensity) * d64 / 1000.0)
    irr = 4.0 * f_number ** 2 * i64 / (exposure_s * camera_gain * math.pi)
    c = fog_ops.beta_hg(90.0) * irr.reshape(-1, 3).mean(0)
    l_in = np.clip(c[None, None] * (1.0 - f_ext)[..., None], 0, 1)
    k = cv2_gaussian_kernel(fog_ops.FOG_BLUR_KSIZE, fog_ops.FOG_BLUR_SIGMA)
    key = ("f64oracle", fog_ops.FOG_BLUR_KSIZE)
    kh = _blur_matrix(h, key, k).astype(np.float64)
    kw = _blur_matrix(w, key, k).astype(np.float64)

    def blur64(x):
        return np.einsum("ij,jw->iw", kh, np.einsum("hj,oj->ho", x, kw))

    f_ext_b = blur64(f_ext)
    l_in_b = np.stack([blur64(l_in[..., ch]) for ch in range(3)], -1)
    return np.clip(i64 * f_ext_b[..., None] + l_in_b, 0, 1)


def fog_precision_check(H=375, W=1242, device=None) -> float:
    """Max abs diff of the fog stage on ``device`` (None: the card)
    against :func:`fog_f64_oracle`, at KITTI's shape by default."""
    rng = np.random.RandomState(3)
    img = rng.rand(H, W, 3).astype(np.float32)
    depth = rng.rand(H, W).astype(np.float32) * 80 + 2
    dev = resolve_device(device)
    got = fog_ops.fog_rain_layer(
        torch.as_tensor(img, device=dev), torch.as_tensor(depth, device=dev),
        rain_intensity=10.0, f_number=6.0, exposure_s=2e-3,
        camera_gain=20.0)
    want = fog_f64_oracle(img, depth)
    return float(np.max(np.abs(got.cpu().double().numpy() - want)))


def _render_diff(got, want):
    """(max abs diff, share of values off by more than RENDER_FAR)."""
    d = (got.cpu() - want.cpu()).abs()
    return d.max().item(), (d > RENDER_FAR).double().mean().item()


def measure(device=None) -> dict:
    """Every number of the self-check on ``device`` (None: the card)
    against the CPU's plain path; :func:`check` holds them to the
    bars."""
    dev = resolve_device(device)
    cfg, (bg, depth, drops, tex, edges, tex_idx) = build_scene(device=dev)
    out = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                              tex_idx=tex_idx)
    cpu = torch.device("cpu")
    ref = frame.render_frames(bg.cpu(), depth.cpu(), drops.to(cpu),
                              tex.to(cpu), edges.cpu(), cfg,
                              tex_idx=tex_idx.cpu())

    # The raster kernel against plain on the scene's rungs.
    _, env_photo, _ = frame.frame_background(bg, depth, cfg)
    params, _ = frame.drop_fused_params(env_photo, drops, tex, edges, cfg,
                                        tex_idx=tex_idx)
    rungs = frame.kernel_rungs(params, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    kernel_err, kernel_bad = 0.0, 0
    for sub in [[r] for r in rungs] + [rungs]:
        got = fused_raster.fused_raster_composite(sub, cfg.image_hw, tex_hw)
        want = fused_raster.fused_raster_plain(sub, cfg.image_hw, tex_hw)
        err = (got - want).abs()
        kernel_err = max(kernel_err, err.max().item())
        kernel_bad += int((err > KERNEL_ATOL
                           + KERNEL_RTOL * want.abs()).sum())

    mask_diff, mask_far = _render_diff(out.rain_mask, ref.rain_mask)
    img_diff, img_far = _render_diff(out.rainy_image, ref.rainy_image)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (out.rain_mask, out.rainy_image, ref.rain_mask,
                  ref.rainy_image))
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "drops": int(drops.count().sum()),
        "finite": finite,
        "mask_mass_gpu": round(out.rain_mask.sum().item(), 3),
        "mask_mass_cpu": round(ref.rain_mask.sum().item(), 3),
        "max_mask_diff": mask_diff,
        "max_img_diff": img_diff,
        "mask_far_share": mask_far,
        "img_far_share": img_far,
        "max_kernel_diff": kernel_err,
        "kernel_values_off": kernel_bad,
        "fog_vs_f64": fog_precision_check(device=dev),
    }


def check(r: dict) -> list:
    """The failed checks of a :func:`measure` result (empty: passed)."""
    fails = []
    if not r["finite"]:
        fails.append("a render holds non-finite values")
    if not r["mask_mass_cpu"] > 1.0:
        fails.append(f"the CPU render produced no rain ({r['mask_mass_cpu']})")
    if not r["mask_mass_gpu"] > 1.0:
        fails.append(f"the card's render produced no rain "
                     f"({r['mask_mass_gpu']})")
    if r["kernel_values_off"]:
        fails.append(f"{r['kernel_values_off']} raster values off plain by "
                     f"more than {KERNEL_ATOL} + {KERNEL_RTOL} * |plain|")
    for name in ("mask", "img"):
        if not (r[f"max_{name}_diff"] <= RENDER_MAX_ABS
                and r[f"{name}_far_share"] <= RENDER_MAX_FAR_FRACTION):
            fails.append(f"{name} diverged: max {r[f'max_{name}_diff']}, "
                         f"share off by > {RENDER_FAR}: "
                         f"{r[f'{name}_far_share']}")
    if not r["fog_vs_f64"] < FOG_F64_BOUND:
        fails.append(f"fog vs f64 oracle {r['fog_vs_f64']:.2e} exceeds "
                     f"{FOG_F64_BOUND}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print("gpu_selfcheck: needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(dev)
    print(json.dumps(result), flush=True)
    fails = check(result)
    for f in fails:
        print(f"FAILED: {f}", file=sys.stderr)
    if fails:
        return 1
    print("GPU self-check PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
