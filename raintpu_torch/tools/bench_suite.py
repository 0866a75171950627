"""The extended benchmark suite: the JAX package's five baseline
configurations (``raintpu.tools.bench_suite``), rendered by the port.

    python -m raintpu_torch.tools.bench_suite [config ...]
        [--device cuda|cpu]

configs: kitti_sweep, cityscapes_envmap, nuscenes_6cam, online, sharded
(default: all), on the CUDA card unless ``--device cpu``. Each prints
one JSON line: ``metric``, ``value`` (images/s), ``unit`` and
``device`` (the card's ``nvidia-smi`` name and power limit, or
``"cpu"``). A configuration that raises prints ``{"metric": name,
"error": ...}`` and the suite goes on, but then exits 1.

Each ``bench_*`` returns that record and, under ``_detail``, its timed
loops (:class:`Run`: the scene, the step and its arguments, the seconds
a step took), which ``main`` drops before printing.

Every configuration runs at the JAX suite's sizes: its intensities,
batches, image sizes and capacity rules. Each step's scalar is summed on
the device over the timed loop and read once at its end, after a
``torch.cuda.synchronize()``; see :func:`timed`. The numbers are
information, not a benchmark's cells.

The port's simulator draws from ``torch.Generator`` s, so its drops
are not the JAX suite's: populations of the same law and size, not the
same drops.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from raintpu_torch import resolve_device
from raintpu_torch.data.textures import (TextureBank,
                                         procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops.rasterize import RasterConfig, fit_raster_config
from raintpu_torch.parallel import distributed
from raintpu_torch.parallel import mesh as pmesh
from raintpu_torch.particles.schema import DropBatch, compact_drop_batch
from raintpu_torch.physics.simulator import (SimConfig,
                                             expected_drop_count,
                                             frame_generator,
                                             simulate_frames,
                                             simulate_frames_keyed,
                                             truncated_count,
                                             truncated_counts)
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings
from raintpu_torch.tools.stage_profile import (CONE_DOWNSAMPLE, card_name,
                                               full_population_capacity)

# Seeds: the simulation of a scene, a step's texture picks (step i
# draws from frame_generator(DRAW_SEED, i)) and the online step's
# simulation (frame_generator(ONLINE_SEED, i)), as the JAX suite keys
# them by PRNGKey(0), PRNGKey(1) and PRNGKey(3).
SIM_SEED = 0
DRAW_SEED = 1
ONLINE_SEED = 3
# Every 97th row and column of the mask and image go into a step's
# scalar (the JAX suite's strided sums).
STRIDE = 97


@dataclasses.dataclass
class Scene:
    """A configuration's render inputs, sized from its population."""

    cfg: frame.PipelineConfig
    sim_cfg: SimConfig
    drops: DropBatch            # compacted to the render capacity
    bg: torch.Tensor            # (B, H, W, 3)
    depth: torch.Tensor         # (B, H, W)
    bank: TextureBank
    edges: torch.Tensor         # (4,) texture ratio-bin edges
    truncated: int              # drops the simulation's capacity cut


@dataclasses.dataclass
class Run:
    """One timed loop of a configuration: ``step(i, *data)`` on
    ``scene``, ``seconds`` a step."""

    scene: Scene
    step: Callable
    data: tuple
    seconds: float


def _perturbed(a, eps: float):
    """``a`` with ``eps`` added to every float tensor in it (a tensor or
    a DropBatch); anything else unchanged."""
    if isinstance(a, DropBatch):
        return a.map(lambda t: t + eps if t.is_floating_point() else t)
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a + eps
    return a


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(step, data, iters=6, perturb_ix=(1, 2, 3)):
    """Seconds per call of ``step(i, *data)``: one warm-up call, then
    one timed loop of ``iters`` calls.

    Call i gets every float tensor of the arguments at ``perturb_ix``
    (by default bg, depth and the drops; the draw seed, the texture bank
    and the bin edges stay as they are) plus ``i * 1e-12``, and the step
    index, from which it keys its own draws: the JAX suite's
    loop-variant inputs and ``fold_in(k, i)``. Eager PyTorch hoists
    nothing out of a loop, but both packages time the same function.
    The steps' 0-d results are summed on the device and read once, after
    a synchronize; so is the clock."""
    device = next(a.device for a in data if isinstance(a, torch.Tensor))

    def call(i):
        eps = i * 1e-12
        return step(i, *[_perturbed(a, eps) if j in perturb_ix else a
                         for j, a in enumerate(data)])

    call(0)
    _sync(device)
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(iters):
        acc = acc + call(i)
    _sync(device)
    dt = time.perf_counter() - t0
    v = acc.item()
    if not v == v:
        raise AssertionError("NaN in benchmark output")
    return dt / iters


def _run(scene: Scene, step, data, iters, **kw) -> Run:
    """``step`` on ``data`` through :func:`timed`, kept as a Run."""
    return Run(scene, step, data, timed(step, data, iters, **kw))


def assert_rain(out, min_mass: float = 1e-2) -> float:
    """Guard against the silent no-op render (rain-mask mass not over
    ``min_mass``) and against bucket-capacity overflow (a fitted ladder
    that under-sizes a rung must fail loudly, not drop drops). Returns
    the mass."""
    mass = float(out.rain_mask.sum())
    if not mass > min_mass:
        raise AssertionError(f"no rain rendered (mask mass {mass})")
    overflow = float(out.overflow.sum())
    if overflow != 0:
        raise AssertionError(f"{overflow} drops overflowed bucket capacity")
    return mass


def build_scene(drops: DropBatch, settings: RenderSettings, W: int,
                H: int, fallrate: float, capacity: int, truncated: int,
                sim_cfg: SimConfig, raster: RasterConfig | None = None,
                **cfg_kw) -> Scene:
    """Compact ``drops`` (B, N) to ``capacity``, fit a bucket ladder to
    them unless ``raster`` gives one, and make the W x H frames: bg and
    depth from RandomState(0), on the drops' device. The cone photometry
    runs at the production setting, cone_downsample 4, unless ``cfg_kw``
    says otherwise."""
    device = drops.valid.device
    B = drops.valid.shape[0]
    drops = compact_drop_batch(drops, capacity)
    db = procedural_streak_database()
    bank = texture_bank(db, device=device)
    if raster is None:
        # The workload-fitted ladder: rungs and capacities from this
        # configuration's own population (the overflow counters guard
        # it).
        raster = fit_raster_config(drops, tuple(bank.raw.shape[1:]),
                                   (W, H), settings)
    cfg_kw.setdefault("cone_downsample", CONE_DOWNSAMPLE)
    cfg = frame.PipelineConfig(settings=settings, image_hw=(H, W),
                               fallrate=float(fallrate), raster=raster,
                               **cfg_kw)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(B, H, W, 3).astype(np.float32),
                         device=device)
    depth = torch.as_tensor((rng.rand(B, H, W) * 60 + 3).astype(np.float32),
                            device=device)
    return Scene(cfg=cfg, sim_cfg=sim_cfg, drops=drops, bg=bg, depth=depth,
                 bank=bank, edges=torch.as_tensor(db.bin_edges, device=device),
                 truncated=int(truncated))


def _settings(W: int, H: int) -> RenderSettings:
    return RenderSettings(camera=CameraSettings(wh=(W, H), ccd_wh=(W, H)))


def filled(B, v, device):
    """A (B,) float32 tensor of ``v`` on ``device``: one simulation rate
    per frame."""
    return torch.full((B,), float(v), dtype=torch.float32, device=device)


def _common(B, W, H, fallrate, capacity=None, settings=None, device=None,
            **cfg_kw) -> Scene:
    """Build a bench scene. ``capacity=None`` sizes the simulation from
    the expected drop population (+5 sigma) and the render capacity
    from the actual max valid count, asserting no truncation — a fixed
    capacity silently truncated heavy intensities in the JAX suite's
    early rounds (50 mm/hr KITTI expects ~1530 simulated drops). With a
    ``capacity``, the simulation holds twice it.

    The drops come from the port's simulator on a generator seeded
    SIM_SEED, so they are not the JAX suite's drops (see the module
    docstring). The scene's ``truncated`` replays the simulation's count
    draw: the drops the simulation capacity cut."""
    device = resolve_device(device)
    if settings is None:
        settings = _settings(W, H)
    if capacity is None:
        probe = SimConfig.from_settings(settings, capacity=1)
        expect = expected_drop_count(probe, float(fallrate))
        sim_cap = int(-(-(expect + 5 * np.sqrt(expect) + 64) // 256) * 256)
    else:
        sim_cap = 2 * capacity
    sim_cfg = SimConfig.from_settings(settings, capacity=sim_cap)
    rates = filled(B, fallrate, device)
    drops = simulate_frames(
        torch.Generator(device=device).manual_seed(SIM_SEED), sim_cfg,
        rates, filled(B, 8.0, device),
        filled(B, settings.camera.exposure_s, device), filled(B, 1.0, device))
    truncated = truncated_count(
        torch.Generator(device=device).manual_seed(SIM_SEED), sim_cfg,
        rates).sum()
    most = int(drops.count().max())
    if not most < sim_cap:
        raise AssertionError(
            f"simulation capacity saturated ({most}/{sim_cap})")
    if capacity is None:
        capacity = -(-most // 128) * 128
    elif most > capacity:
        raise AssertionError(
            f"render capacity truncates ({most}/{capacity})")
    return build_scene(drops, settings, W, H, fallrate, capacity,
                       truncated, sim_cfg, **cfg_kw)


def _step_scalar(out, envmap: bool = False) -> torch.Tensor:
    """A step's 0-d result: strided sums of the mask and the image and,
    with ``envmap``, the sum of the WHOLE envmap — a strided slice would
    time a map the pipeline does not save (the JAX suite's round-3
    finding: the envmap's step cost read 5 ms against a real 37 ms)."""
    s = (out.rain_mask[:, ::STRIDE, ::STRIDE].sum()
         + out.rainy_image[:, ::STRIDE, ::STRIDE].sum())
    return s + out.envmap.sum() if envmap else s


def render_step(cfg: frame.PipelineConfig, envmap: bool = False):
    """The timed step of a render configuration,
    ``step(i, seed, bg, depth, drops, bank, edges, tex_idx=None)``:
    one ``render_frames`` whose texture picks come from
    ``frame_generator(seed, i)`` (or are ``tex_idx``), reduced by
    :func:`_step_scalar`."""
    def step(i, seed, bg, depth, drops, bank, edges, tex_idx=None):
        gen = (None if tex_idx is not None
               else frame_generator(seed, i, bg.device))
        out = frame.render_frames(bg, depth, drops, bank, edges, cfg,
                                  generator=gen, tex_idx=tex_idx)
        return _step_scalar(out, envmap)
    return step


def step_args(scene: Scene):
    """The arguments after ``i`` of :func:`render_step`'s step."""
    return (DRAW_SEED, scene.bg, scene.depth, scene.drops, scene.bank,
            scene.edges)


def checked(scene: Scene, min_mass: float = 1e-2) -> float:
    """The scene rendered once (draws of step 0), checked for rain and
    overflow by :func:`assert_rain`. Returns the rain-mask mass."""
    out = frame.render_frames(
        scene.bg, scene.depth, scene.drops, scene.bank, scene.edges,
        scene.cfg, generator=frame_generator(DRAW_SEED, 0,
                                             scene.bg.device))
    return assert_rain(out, min_mass)


def bench_kitti_sweep(device=None, B=12, W=1242, H=375,
                      fallrates=(1, 5, 25, 50), iters=6):
    """Intensity sweep {1, 5, 25, 50} mm/hr at KITTI size, batch 12 (the
    JAX suite's config 2); auto capacity: the full population at every
    intensity."""
    runs = []
    for fr in fallrates:
        scene = _common(B, W, H, fr, device=device)
        checked(scene)
        runs.append(_run(scene, render_step(scene.cfg), step_args(scene),
                         iters))
    rate = len(fallrates) * B / sum(r.seconds for r in runs)
    return {"metric": "KITTI sweep {" + ",".join(f"{f:g}" for f in fallrates)
                      + "}mm/hr",
            "value": rate, "unit": "images/s", "_detail": runs}


def bench_cityscapes_envmap(device=None, B=12, W=1024, H=512,
                            fallrate=25.0, iters=6):
    """Cityscapes at render_scale 2 (1024x512) with the full-resolution
    envmap saved (config 3); the step pays for the whole envmap."""
    scene = _common(B, W, H, fallrate, device=device, save_envmap=True)
    checked(scene)
    run = _run(scene, render_step(scene.cfg, envmap=True),
               step_args(scene), iters)
    return {"metric": f"Cityscapes {W}x{H} + envmap @{fallrate:g}mm/hr",
            "value": B / run.seconds, "unit": "images/s", "_detail": [run]}


def bench_nuscenes_6cam(device=None, B=6, W=1600, H=900, fallrate=100.0,
                        iters=6):
    """nuScenes 6-camera rig @100 mm/hr (config 4), the whole rig in one
    step: the simulation capacity from the expected drop count (+5
    sigma), one simulation per camera on its own generator, ZERO
    truncation and ZERO bucket overflow asserted, so the step renders
    every drop of the population."""
    device = resolve_device(device)
    settings = _settings(W, H)
    sim_cfg = SimConfig.from_settings(
        settings, capacity=full_population_capacity(settings, fallrate))

    def cameras():
        return [frame_generator(SIM_SEED, c, device) for c in range(B)]

    rates = filled(B, fallrate, device)
    drops = simulate_frames_keyed(
        cameras(), sim_cfg, rates, filled(B, 8.0, device),
        filled(B, settings.camera.exposure_s, device), filled(B, 1.0, device))
    trunc = int(truncated_counts(cameras(), sim_cfg, rates).sum())
    if trunc != 0:
        raise AssertionError(f"population truncated by {trunc} drops")
    counts = drops.count()
    render_cap = -(-int(counts.max()) // 128) * 128
    scene = build_scene(drops, settings, W, H, fallrate, render_cap,
                        trunc, sim_cfg)
    checked(scene)
    run = _run(scene, render_step(scene.cfg), step_args(scene), iters)
    rate = B / run.seconds
    dpf = float(counts.float().mean())
    return {"metric": f"nuScenes {B}x{W}x{H} rig @{fallrate:g}mm/hr, FULL "
                      f"rig in one step (full population ~{dpf:.0f} "
                      f"drops/frame, truncated=0, overflow=0, "
                      f"drops/s={rate * dpf:.0f})",
            "value": rate, "unit": "images/s", "_detail": [run]}


def bench_online(device=None, B=12, W=1242, H=375, fallrate=25.0,
                 iters=6):
    """Online mode (config 5): every step simulates its batch on the
    device (keyed by the step), compacts it and renders it."""
    device = resolve_device(device)
    scene = _common(B, W, H, fallrate, device=device)
    sim_cfg = scene.sim_cfg

    def simulate(gen):
        return simulate_frames(gen, sim_cfg, filled(B, fallrate, device),
                               filled(B, 8.0, device),
                               filled(B, 2e-3, device), filled(B, 1.0, device))

    drops0 = simulate(torch.Generator(device=device).manual_seed(
        ONLINE_SEED))
    # Compaction in the step to the valid population with 1.3x headroom
    # (the online job does the same): prep scales with capacity.
    cap = min(-(-(int(int(drops0.count().max()) * 1.3) + 64) // 128) * 128,
              sim_cfg.capacity)
    render = render_step(scene.cfg)

    def step(i, seed, bg, depth, bank, edges):
        drops = compact_drop_batch(
            simulate(frame_generator(ONLINE_SEED, i, device)), cap)
        return render(i, seed, bg, depth, drops, bank, edges)

    assert_rain(frame.render_frames(
        scene.bg, scene.depth, drops0, scene.bank, scene.edges, scene.cfg,
        generator=frame_generator(DRAW_SEED, 0, device)))
    # The drops are simulated in the step, keyed by i: only bg and depth
    # need the perturbation.
    run = _run(scene, step, (DRAW_SEED, scene.bg, scene.depth, scene.bank,
                             scene.edges), iters, perturb_ix=(1, 2))
    return {"metric": f"online sim+render KITTI @{fallrate:g}mm/hr",
            "value": B / run.seconds, "unit": "images/s", "_detail": [run]}


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def bench_sharded(device=None, B=48, W=1242, H=375, fallrate=10.0,
                  capacity=320, iters=6):
    """The sharded step (``parallel.mesh.render_frames_sharded``, the
    fused kernel) over the default process group's ranks as dp x sp=1;
    B matches the headline batch so the two are comparable. Without a
    group it starts a one-rank group (nccl on the card, gloo on the CPU)
    and ends it after. Each rank renders its share of the B frames; the
    rate is B over one step."""
    device = resolve_device(device)
    own_group = not dist.is_initialized()
    if own_group:
        distributed.initialize(_free_address(), 1, 0, device=device.type)
    try:
        n = dist.get_world_size()
        scene = _common(B, W, H, fallrate, capacity, device=device,
                        composite_mode="fused")
        mesh = pmesh.make_mesh(n_devices=n, sp=1, device_type=device.type)
        lo, hi = distributed.local_batch_bounds(B)
        mine = slice(lo, hi)
        data = (DRAW_SEED, scene.bg[mine], scene.depth[mine],
                scene.drops.map(lambda t: t[mine]), scene.bank, scene.edges)

        def step(i, seed, bg, depth, drops, bank, edges):
            out = pmesh.render_frames_sharded(
                mesh, bg, depth, drops, bank, edges, scene.cfg,
                generator=frame_generator(seed, i, device))
            return _step_scalar(out)

        assert_rain(pmesh.render_frames_sharded(
            mesh, *data[1:], scene.cfg,
            generator=frame_generator(DRAW_SEED, 0, device)))
        run = _run(scene, step, data, iters)
    finally:
        if own_group:
            dist.destroy_process_group()
    return {"metric": f"sharded dp={n} x sp=1 KITTI @{fallrate:g}mm/hr "
                      "(fused kernel under render_frames_sharded)",
            "value": B / run.seconds, "unit": "images/s", "_detail": [run]}


CONFIGS = {
    "kitti_sweep": bench_kitti_sweep,
    "cityscapes_envmap": bench_cityscapes_envmap,
    "nuscenes_6cam": bench_nuscenes_6cam,
    "online": bench_online,
    "sharded": bench_sharded,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m raintpu_torch.tools.bench_suite")
    ap.add_argument("configs", nargs="*", metavar="config",
                    help=f"any of {', '.join(CONFIGS)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in CONFIGS]
    if unknown:
        ap.error(f"unknown config(s) {unknown}: choose from "
                 f"{', '.join(CONFIGS)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_suite: no CUDA card (pass --device cpu to "
                         "run on the CPU)")
    where = card_name() if device.type == "cuda" else "cpu"
    rc = 0
    for name in args.configs or list(CONFIGS):
        try:
            rec = CONFIGS[name](device=device)
            del rec["_detail"]
            rec["device"] = where
        except Exception as e:  # keep the suite going; exit 1 at the end
            traceback.print_exc()
            rec = {"metric": name, "error": f"{type(e).__name__}: {e}"[:200]}
            rc = 1
        print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
