"""The headline benchmark (the JAX package's ``bench.py``): workload A,
KITTI 1242x375 at 10 mm/hr, batch 48, rendered by the port.

    python -m raintpu_torch.bench

Prints comment lines (``# device: ...``, ``# kernels built ...``, the
timed runs' spread, ``# fitted ladder: ...`` under FITTED=1) and, last,
ONE JSON line::

    {"metric": ..., "value": N, "unit": "images/s", "steady_state": N,
     "fields_dtype": ..., "modal_blur": ..., "cone_downsample": ...,
     "ladder": [[ph, pw,
     radius, capacity], ...], "device": ..., "launches": {"raster": n,
     "blur": n}}

``value`` times the render with every float input of the frames, the
depth maps and the drops moved by ``i * 1e-12`` on step i
(:func:`raintpu_torch.tools.bench_suite.timed`); ``steady_state`` times
it on inputs that stay as they are. The JAX bench needs the
perturbation because XLA hoists loop-invariant stages out of its device
loop; eager PyTorch hoists nothing out of a loop, so here both numbers
time the same render, apart from the perturbation's adds, and both are
kept as the JAX line keeps them. Each is BATCH over the median seconds
a step took in REPS timed loops of ITERS steps, each loop after one
warm-up step. A step's texture picks come from
``frame_generator(DRAW_SEED, i)``; its scalar (strided sums of the mask
and the image) stays on the device, the loop's sum is read once, after
a synchronize, and so is the clock.

Honesty guards, before any timing: one render (the draws of step 0)
must put rain on the frames (rain-mask mass > 1) and no drop may
overflow its rung, else AssertionError. On the card that render must
launch the raster kernel once (every rung in one launch) and the blur
kernel once (the fog); ``launches`` reports the counts (0 and 0 on the
CPU, where every kernel runs its plain version).

Knobs (environment variables):
  HW (375x1242), BATCH (48), CAPACITY (320), FALLRATE (10), ITERS (10)
      the workload's shape;
  MODAL=0  modal blur off (RasterConfig.modal_blur);
  CDS      cone_downsample of the drop photometry (4; 1 is exact);
  FIELDS_DTYPE  the field planes' dtype (PipelineConfig.fields_dtype):
           float32 (the default) or bfloat16, whose raster kernel rounds
           each drop's contribution into bfloat16 planes as the JAX
           package's kernels do;
  FITTED=1 fit_raster_config's ladder, fitted to these drops, in place
           of the hand ladder (the modal-blur setting kept);
  DEVICE   cuda (the default) or cpu. Without a CUDA card, cuda is
           refused before any work and no JSON line is printed.

The JAX bench's TPU kernel levers (PAIR, ROW_STRIP, NARROW, RESIDENT),
their hardware gate and its backend probe have no
counterpart: the port has one raster kernel and one blur kernel (and the
cone photometry's kernel), built from ``raintpu_torch/csrc/`` before
the first render, and ``launches`` says that the first two ran. The drops come from the port's simulator on a
generator seeded SIM_SEED, so they are drops of the same law and
number as the JAX bench's, not the same drops.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from raintpu_torch import cuda_build, resolve_device
from raintpu_torch.ops import blur_kernel, fused_raster
from raintpu_torch.ops.rasterize import RasterConfig, fit_raster_config
from raintpu_torch.physics.simulator import (SimConfig, simulate_frames,
                                             truncated_count)
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings
from raintpu_torch.tools.bench_suite import (SIM_SEED, Scene, build_scene,
                                             checked, filled, render_step,
                                             step_args, timed)
from raintpu_torch.tools.stage_profile import HAND_LADDER, card_name

# Workload A: the knobs' defaults.
HW = (375, 1242)
BATCH = 48
CAPACITY = 320
FALLRATE = 10.0
ITERS = 10
CDS = 4
# The simulation's capacity: the whole population, before it is packed
# to the render capacity.
SIM_CAPACITY = 512
# Timed loops a number is the median of.
REPS = 5
# The guard: a render with less rain-mask mass than this rendered none.
MIN_MASK_MASS = 1.0
KERNELS = ("fused_raster", "separable_blur", "cone_sums")
# The environment variables the bench reads.
KNOBS = ("HW", "BATCH", "CAPACITY", "FALLRATE", "ITERS", "MODAL", "CDS",
         "FITTED", "DEVICE", "FIELDS_DTYPE")


def workload(device, hw=HW, batch=BATCH, capacity=CAPACITY,
             fallrate=FALLRATE, modal_blur=True, cds=CDS,
             generator=None, fields_dtype="float32") -> Scene:
    """Workload A on ``device``, as a bench_suite Scene: KITTI's camera,
    the hand ladder, drops simulated at capacity SIM_CAPACITY (rates
    ``fallrate`` mm/hr, 8 m deep, KITTI's exposure) from ``generator``
    (default: a fresh one seeded SIM_SEED) and packed to ``capacity``;
    frames and depth maps from ``RandomState(0)``; the procedural
    texture bank; ``fields_dtype`` the field planes' dtype. Its
    ``truncated`` replays the simulation's count draw on a copy of the
    generator."""
    device = torch.device(device)
    H, W = hw
    settings = RenderSettings(camera=CameraSettings())  # KITTI defaults
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(SIM_SEED)
    sim_cfg = SimConfig.from_settings(settings, capacity=SIM_CAPACITY)
    rates = filled(batch, fallrate, device)
    replay = torch.Generator(device=device)
    replay.set_state(generator.get_state())
    truncated = int(truncated_count(replay, sim_cfg, rates).sum())
    drops = simulate_frames(
        generator, sim_cfg, rates, filled(batch, 8.0, device),
        filled(batch, settings.camera.exposure_s, device),
        filled(batch, 1.0, device))
    return build_scene(
        drops, settings, W, H, fallrate, capacity, truncated, sim_cfg,
        raster=RasterConfig(buckets=HAND_LADDER, modal_blur=modal_blur),
        cone_downsample=cds, fields_dtype=fields_dtype)


def fitted(scene: Scene) -> Scene:
    """``scene`` with fit_raster_config's ladder for its drops (the
    modal blur setting kept)."""
    H, W = scene.cfg.image_hw
    raster = fit_raster_config(scene.drops, tuple(scene.bank.raw.shape[1:]),
                               (W, H), scene.cfg.settings)
    raster = dataclasses.replace(raster,
                                 modal_blur=scene.cfg.raster.modal_blur)
    return dataclasses.replace(
        scene, cfg=dataclasses.replace(scene.cfg, raster=raster))


def ladder(cfg: frame.PipelineConfig) -> list:
    return [[b.ph, b.pw, b.radius, b.capacity] for b in cfg.raster.buckets]


def guard(scene: Scene):
    """bench_suite's check of one render (the draws of step 0; rain-mask
    mass over MIN_MASK_MASS, no overflow) with its launches counted: on
    the card, one raster and one blur launch. Returns (mass,
    launches)."""
    raster0 = fused_raster.fused_raster_composite.launches
    blur0 = blur_kernel.separable_blur.launches
    mass = checked(scene, MIN_MASK_MASS)
    launches = {"raster": fused_raster.fused_raster_composite.launches
                - raster0,
                "blur": blur_kernel.separable_blur.launches - blur0}
    if scene.bg.device.type == "cuda" and launches != {"raster": 1,
                                                       "blur": 1}:
        raise AssertionError(f"the render made {launches} launches, not "
                             "one raster and one blur launch")
    return mass, launches


def rate(step, data, batch, iters, reps=REPS, **kw):
    """(images/s, each loop's images/s): ``batch`` over the median
    seconds a step took in ``reps`` loops of :func:`timed`."""
    secs = [timed(step, data, iters, **kw) for _ in range(reps)]
    return batch / float(np.median(secs)), [batch / s for s in secs]


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) == "1"


def main() -> dict:
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raintpu_torch.bench: no CUDA card (set "
                         "DEVICE=cpu to run on the CPU)")
    where = card_name() if device.type == "cuda" else "cpu"
    print(f"# device: {where}", flush=True)
    if device.type == "cuda":
        t0 = time.perf_counter()
        cuda_build.build_all(KERNELS)
        for name in KERNELS:
            cuda_build.load(name)
        print(f"# kernels built: {', '.join(KERNELS)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    H, W = (int(v) for v in os.environ.get("HW", "375x1242").split("x"))
    batch = int(os.environ.get("BATCH", str(BATCH)))
    fallrate = float(os.environ.get("FALLRATE", str(FALLRATE)))
    iters = int(os.environ.get("ITERS", str(ITERS)))
    w = workload(device, (H, W), batch,
                 int(os.environ.get("CAPACITY", str(CAPACITY))), fallrate,
                 modal_blur=_env_flag("MODAL"),
                 cds=int(os.environ.get("CDS", str(CDS))),
                 fields_dtype=os.environ.get("FIELDS_DTYPE", "float32"))
    drops_per_frame = float(w.drops.count().float().mean())
    if _env_flag("FITTED", "0"):
        w = fitted(w)
        print("# fitted ladder:", ladder(w.cfg), flush=True)

    mass, launches = guard(w)
    step = render_step(w.cfg)
    honest, runs = rate(step, step_args(w), batch, iters)
    print("# value runs (images/s):", [round(r, 2) for r in runs],
          flush=True)
    steady, runs = rate(step, step_args(w), batch, iters, perturb_ix=())
    print("# steady_state runs (images/s):", [round(r, 2) for r in runs],
          flush=True)
    rec = {
        "metric": "KITTI 1242x375 fresh-frame render throughput "
                  f"@{fallrate:g}mm/hr (batch={batch}, "
                  f"~{drops_per_frame:.0f} drops/frame, "
                  f"drops/s={honest * drops_per_frame:.0f}, "
                  f"mask_mass={mass:.1f}, device={where})",
        "value": round(honest, 2),
        "unit": "images/s",
        "steady_state": round(steady, 2),
        "fields_dtype": w.cfg.fields_dtype,
        "modal_blur": w.cfg.raster.modal_blur,
        "cone_downsample": w.cfg.cone_downsample,
        "ladder": ladder(w.cfg),
        "device": where,
        "launches": launches,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
