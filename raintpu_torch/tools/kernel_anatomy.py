"""Per-rung cost anatomy of the raster kernel on the card (the port's
``raintpu.tools.kernel_anatomy``).

An occupancy sweep of the production kernel (``ops/fused_raster``,
``csrc/fused_raster.cu``) on workload A — KITTI 1242x375 at
``--fallrate`` mm/hr (10), batch 48, drops simulated at capacity 512
and compacted to 320, the bench's hand ladder, ``cone_downsample`` 4 —
whose rungs come from one prep pass (``frame.frame_background`` ->
``frame.drop_fused_params`` -> ``frame.kernel_rungs``). For each rung
alone (K1's use) and then for all rungs in one launch (the production
launch, K3's scheme) it derives:

  v = us per valid drop: the slope of time against n_valid at fixed
      capacity, between the rows n_valid <= 0 and n_valid <= cap of the
      rows {0, cap/4, cap/2, cap};
  g = us per gated slot: the slope of time against capacity at zero
      valid drops, the capacity doubled by zero slots (:func:`pad_rung`).

The kernel reads n_valid on the card and its scan visits only the valid
slots, so a slot past n_valid should cost nothing (g near 0), unlike the
TPU kernel's gated grid steps: a clearly non-zero g is a finding about
the scan. Beside each rung's full-capacity row stands the call's bound
(:func:`raster_bound`: the operations of every window pixel in the
image of every valid slot at the fp32 peak, or the operands read once
and the planes written once at the memory rate, whichever is larger).

Each time is the median of REPS windows of CUDA events, each around
ITERS back-to-back launches, after one warm-up launch; nothing but the
kernel is launched in between. Eager
launches are never hoisted out of a loop, so the JAX tool's i * 1e-12
perturbation of the params (which defeated XLA's loop-invariant code
motion) is not needed here. Timing needs the card: on the CPU only the
helpers run.

Usage:  python -m raintpu_torch.tools.kernel_anatomy [--fallrate 10]
            [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from raintpu_torch import bench, resolve_device
from raintpu_torch.ops import fused_raster
from raintpu_torch.ops.fused_raster import N_PLANES, RasterRung
from raintpu_torch.render import frame
from raintpu_torch.tools.stage_profile import card_name

B = bench.BATCH
ITERS = 30
# Windows of ITERS launches per time; their median is kept (a window of
# short launches right after another variant's varied by 2x).
REPS = 5
# Peak rates of one H100 SXM (NVIDIA data sheet) for the bounds.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Raster operations per evaluated window pixel besides the DCT series
# (5 per mode and axis per rank, 2 per rank): the homography and its
# divide, 2 cos, the tanh-erf window (4 tanh and their polynomials), the
# clamp and cutoff, and the plane contributions (log included). Each
# transcendental counts as one operation.
RASTER_FIXED_OPS = 70


def bound_ms(flops: float, nbytes: float):
    """(least ms, what bounds it) from fp32 operations and bytes."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def raster_bytes(rungs, image_hw, n_planes, dtype=torch.float32) -> int:
    """The bytes one raster call over ``rungs`` must move: the operands
    read once and the planes (of ``dtype``) written once."""
    h, w = image_hw
    return (sum(t.numel() * t.element_size() for r in rungs
                for t in (r.params, r.anchor, r.ayc, r.bxc))
            + rungs[0].params.shape[0] * n_planes * h * w
            * torch.finfo(dtype).bits // 8)


def raster_bound(rungs, image_hw, n_planes, dtype=torch.float32):
    """Bound of one raster call over ``rungs``: the operations of every
    window pixel inside the image of every valid slot, and the bytes of
    :func:`raster_bytes`. Returns (ms, "operations" or "bytes", window
    px)."""
    h, w = image_hw
    ops = 0.0
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
    return bound_ms(ops, raster_bytes(rungs, image_hw, n_planes,
                                      dtype)) + (px,)


def workload(fallrate: float = 10.0, device=None) -> dict:
    """Workload A's kernel operands on ``device`` (None: the card), A as
    the headline bench builds it: the config, the rungs of one prep
    pass and the texture canvas."""
    dev = resolve_device(device)
    w = bench.workload(dev, fallrate=fallrate)
    _, env_photo, _ = frame.frame_background(w.bg, w.depth, w.cfg)
    params, _ = frame.drop_fused_params(
        env_photo, w.drops, w.bank, w.edges, w.cfg,
        generator=torch.Generator(device=dev).manual_seed(1))
    return dict(cfg=w.cfg, rungs=frame.kernel_rungs(params, w.cfg),
                tex_hw=tuple(w.bank.raw.shape[1:]))


def pad_rung(rung: RasterRung, cap: int) -> RasterRung:
    """``rung`` with its slots padded to ``cap`` by zero slots (n_valid
    unchanged): the same drops in a larger capacity."""
    c = rung.params.shape[2]
    if cap < c:
        raise ValueError(f"pad_rung: capacity {cap} below the rung's {c}")

    def pad(t, dim):
        shape = list(t.shape)
        shape[dim] = cap - c
        return torch.cat([t, t.new_zeros(shape)], dim=dim).contiguous()

    return dataclasses.replace(
        rung, params=pad(rung.params, 2), anchor=pad(rung.anchor, 1),
        ayc=pad(rung.ayc, 1), bxc=pad(rung.bxc, 1))


def cap_valid(rung: RasterRung, n: int) -> RasterRung:
    """``rung`` with each frame's n_valid cut to at most ``n``."""
    return dataclasses.replace(
        rung, n_valid=torch.clamp(rung.n_valid, max=n).contiguous())


def mean_valid(rungs) -> float:
    """Valid slots per frame, summed over ``rungs``."""
    return float(sum(r.n_valid.double().mean() for r in rungs))


def launch_ms(rungs, image_hw, tex_hw, ablate: str = "",
              iters: int = ITERS, reps: int = REPS,
              n_planes: int = N_PLANES, dtype=torch.float32) -> float:
    """ms per launch of the kernel (variant ``ablate``, planes of
    ``dtype``) on ``rungs``: the median over ``reps`` windows of CUDA
    events around ``iters`` back-to-back launches, after one warm-up
    launch. Raises unless the wrapper counted one launch per call."""
    if rungs[0].params.device.type != "cuda":
        raise ValueError("launch_ms: timing needs tensors on the card")
    fn = fused_raster.fused_raster_composite
    before = fn.launches
    fn(rungs, image_hw, tex_hw, n_planes, ablate, dtype)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(rungs, image_hw, tex_hw, n_planes, ablate, dtype)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    calls = 1 + reps * iters
    if fn.launches - before != calls:
        raise RuntimeError(f"launch_ms: {fn.launches - before} launches of "
                           f"{calls} calls (ablate {ablate!r})")
    return float(np.median(times))


def valid_slope(rows, batch: int):
    """us per valid drop from rows (n_valid cap, valid slots per frame,
    ms): the slope between the first and the last row, as the JAX tool
    computes it; None when the valid count does not grow."""
    (_, m0, t0), (_, m1, t1) = rows[0], rows[-1]
    if not m1 > m0:
        return None
    return (t1 - t0) * 1000.0 / ((m1 - m0) * batch)


def gated_slope(ms_zero: float, ms_doubled: float, cap: int,
                batch: int) -> float:
    """us per gated slot: the time added by ``cap`` more empty slots in
    each of ``batch`` frames, at zero valid drops."""
    return (ms_doubled - ms_zero) * 1000.0 / (cap * batch)


def sweep(rungs, image_hw, tex_hw) -> dict:
    """The occupancy rows and slopes of one launch over ``rungs``: each
    rung's n_valid cut to 0, 1/4, 1/2 and all of its capacity (a row:
    the cuts, valid slots per frame, ms), then the capacities doubled at
    0 valid."""
    batch = rungs[0].n_valid.shape[0]
    caps = [r.params.shape[2] for r in rungs]
    rows = []
    for k in (0, 1, 2, 4):
        nval = tuple(cap * k // 4 for cap in caps)
        cut = [cap_valid(r, n) for r, n in zip(rungs, nval)]
        rows.append((nval, mean_valid(cut),
                     launch_ms(cut, image_hw, tex_hw)))
    doubled = [cap_valid(pad_rung(r, 2 * cap), 0)
               for r, cap in zip(rungs, caps)]
    ms2 = launch_ms(doubled, image_hw, tex_hw)
    return dict(rows=rows, v=valid_slope(rows, batch), ms_doubled=ms2,
                g=gated_slope(rows[0][2], ms2, sum(caps), batch),
                bound=raster_bound(rungs, image_hw, N_PLANES))


def anatomy(rungs, buckets, image_hw, tex_hw, smi: str = "",
            log=print) -> dict:
    """:func:`sweep` for each rung alone and for all rungs in one
    launch, each printed as the JAX tool prints it, with the full
    rows' bound. Returns {"rung<i>": sweep, "all": sweep}."""
    batch = rungs[0].n_valid.shape[0]
    out = {}
    parts = [(f"rung{i}", [r], f"({b.ph},{b.pw},{b.radius})")
             for i, (r, b) in enumerate(zip(rungs, buckets))]
    parts.append(("all", rungs, "+".join(f"({b.ph},{b.pw})"
                                         for b in buckets)))
    for name, sub, shape in parts:
        s = sweep(sub, image_hw, tex_hw)
        caps = "+".join(str(r.params.shape[2]) for r in sub)
        for nval, mv, ms in s["rows"]:
            log(f"{name} {shape} cap={caps} nval<={'+'.join(map(str, nval))}"
                f" (mean {mv:6.1f}) {ms:8.4f} ms")
        bnd, by, px = s["bound"]
        log(f"{name}: full rows' bound {bnd:.4f} ms ({by}; {px} window px),"
            f" {s['rows'][-1][2] / bnd:.2f}x the bound")
        if s["v"] is not None:
            log(f"{name}: v = {s['v']:.4f} us/valid-drop")
        log(f"{name}: g = {s['g']:.5f} us/gated-slot (cap x2 @0 valid: "
            f"{s['rows'][0][2]:.4f}->{s['ms_doubled']:.4f} ms)"
            + (f"; on {smi}" if smi else ""))
        out[name] = s
    out["batch"] = batch
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fallrate", type=float, default=10.0,
                    help="mm/hr of workload A (default 10)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("kernel_anatomy: times the kernel on a CUDA card")
    w = workload(args.fallrate, dev)
    rungs = w["rungs"]
    print(f"# batch {B}, {args.fallrate:g} mm/hr; per-rung n_valid mean: "
          + str([round(float(r.n_valid.double().mean()), 2)
                 for r in rungs]), flush=True)
    smi = card_name()
    return anatomy(rungs, w["cfg"].raster.buckets, w["cfg"].image_hw,
                   w["tex_hw"], smi=smi,
                   log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
