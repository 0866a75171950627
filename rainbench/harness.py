"""One run of a cell: the program set up as the render job sets it up,
a closed loop of render steps for the window, the outputs judged
against the reference, and the metrics read.

Set-up makes the pool (``inputs.make_pool``), builds and loads the
program's two CUDA kernels (``raintpu_torch/_build/``, built on a
checkout's first run), makes the program's texture bank from the raw
streak textures, fits the program's ladder over the whole pool
(``fit_raster_config``) and builds its ``PipelineConfig`` from the
configuration's settings, then renders every pool batch once and the
first again: each shape the window uses is then built and warmed, and
the memory it holds allocated. A run that compiles says so in its
``build`` key.

Step i renders pool batch i mod P through ``render_frames`` with the
batch's texture picks as data, as the job does, and ends in a
synchronize. Under a traffic mix whose ``drops`` is ``"online"`` the
step first makes the batch's drops and picks as the online job does
(:class:`OnlineDrops`, inside the span ``online.drops``), and set-up
runs that source over the pool once, for the job's render capacity to
settle and the ladder to be fitted, before the warm steps. The window
closes after the first step that ends ``seconds`` after it opened. The
output of the latest step of each pool batch is kept; after the window
those outputs are judged (:mod:`rainbench.check`). With ``trace``, the
window opens with two ``torch.profiler`` windows of ``trace_steps``
steps each: the first records host operations too, and only names the
idle gaps (recording them slows a host-bound step); the second records
the device alone, timed by the host clock, and gives every per-layer
metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import List, Optional

import torch

from rainbench import card, inputs, spec
from rainbench import trace as trace_view

KERNELS = ("fused_raster", "separable_blur")
OUT_DIR = spec.ROOT / "rainbench_out"
# The controls, the program in a lower precision, which a cell's limits
# must fail: "bf16", bfloat16 field planes (``fields_dtype``, the
# program's own mode); "tf32", TF32 matmuls (the envmap feather, the
# cone sums, the modal analysis).
CONTROLS = ("bf16", "tf32")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StepInputs:
    """What a kernel count reads of one traced step."""

    drops: dict
    settings: dict
    image_hw: tuple
    tex_hw: tuple


class OnlineDrops:
    """The online job's drop source, as ``render/online.OnlineRenderJob``
    and ``render/pipeline.RenderJob`` run it for a batch, through the
    port's public functions in the job's order: each frame simulated on
    its own generator (``physics/simulator.frame_generator`` of (seed,
    frame), ``simulate_frames_keyed``), the drops lost to the simulation
    capacity counted by replaying the count draw (``truncated_counts``),
    the batch compacted to the job's render capacity (its largest valid
    count x1.3 + 64, 128-aligned, refitted upward; ``compact_drop_batch``
    after a read of that count, which waits for the device), and each
    frame's texture picks drawn on a generator seeded
    ``seed * 100003 + frame`` (``ops/rasterize.select_textures``).

    The job counts a frame's truncation once, and renders every frame
    once; the window cycles the pool's frames, so the count runs for
    every frame of every batch, as each new batch of the job's has it.
    Fall rate, exposure and focal scale come from the program's
    ``schedule_from_settings``, the camera speeds from the pool."""

    def __init__(self, cell: spec.Cell, pool: inputs.Pool, seed: int,
                 device):
        from raintpu_torch.physics.simulator import (SimConfig,
                                                     schedule_from_settings)
        from raintpu_torch.render.camera import settings_from_dict

        t = cell.traffic
        settings = settings_from_dict(cell.config["settings"])
        self.sim = SimConfig.from_settings(
            settings, capacity=int(t["sim_capacity"]))
        self.traffic = t
        self.seed = int(seed)
        self.device = torch.device(device)
        fall, _, expo, focal = schedule_from_settings(
            settings, float(t["fallrate_mm_hr"]),
            n_frames=pool.speeds_mps.numel())
        self.schedule = (fall, pool.speeds_mps.flatten().cpu().numpy(),
                         expo, focal)
        self.render_cap = None
        self.truncated = torch.zeros((), dtype=torch.int64,
                                     device=self.device)

    def _compact(self, batch):
        """OnlineRenderJob._compact_for_render's rule."""
        from raintpu_torch.particles.schema import compact_drop_batch

        sim_cap = batch.valid.shape[-1]
        vmax = int(batch.count().max())
        if self.render_cap is None or vmax > self.render_cap:
            self.render_cap = min(-(-(int(vmax * 1.3) + 64) // 128) * 128,
                                  sim_cap)
        if self.render_cap >= sim_cap:
            return batch
        return compact_drop_batch(batch, self.render_cap)

    def __call__(self, j: int, edges: torch.Tensor):
        """(DropBatch (B, N, ...), picks (B, N)) of pool batch ``j``."""
        from raintpu_torch.ops.rasterize import select_textures
        from raintpu_torch.physics.simulator import (frame_generator,
                                                     simulate_frames_keyed,
                                                     truncated_counts)
        from raintpu_torch.utils import profiling

        frames = inputs.online_frames(self.traffic, j)
        dev = self.device
        # The drops belong to the render step render_frames begins next.
        span = profiling.span("online.drops")
        span.step += 1
        with span:
            cols = [torch.as_tensor(a[frames], device=dev)
                    for a in self.schedule]
            batch = simulate_frames_keyed(
                [frame_generator(self.seed, f, dev) for f in frames],
                self.sim, *cols)
            self.truncated += truncated_counts(
                [frame_generator(self.seed, f, dev) for f in frames],
                self.sim, cols[0]).sum()
            drops = self._compact(batch)
            picks = torch.stack([
                select_textures(drops.map(lambda t: t[b]), edges,
                                torch.Generator(device=dev).manual_seed(
                                    self.seed * inputs.PICK_STRIDE + f))
                for b, f in enumerate(frames)])
        return drops, picks


def _fields(drops) -> dict:
    return {f.name: getattr(drops, f.name)
            for f in dataclasses.fields(drops)}


class Program:
    """The system under test, set up from a cell and its pool; with
    ``control`` (one of CONTROLS), in that lower precision. Under the
    online source the program makes each step's drops and picks from
    the run's ``seed`` (:class:`OnlineDrops`)."""

    def __init__(self, cell: spec.Cell, pool: inputs.Pool, device,
                 control: Optional[str] = None, seed: int = 0):
        if control not in (None,) + CONTROLS:
            raise ValueError(f"control {control!r} is not one of {CONTROLS}")
        from raintpu_torch.data.textures import StreakDatabase, texture_bank
        from raintpu_torch.ops.rasterize import fit_raster_config
        from raintpu_torch.particles.schema import DropBatch
        from raintpu_torch.render import frame
        from raintpu_torch.render.camera import settings_from_dict

        self.frame = frame
        self.pool = pool
        settings = settings_from_dict(cell.config["settings"])
        self.bank = texture_bank(StreakDatabase(textures=pool.textures,
                                                bin_edges=pool.bin_edges),
                                 device=device)
        self.edges = torch.as_tensor(pool.bin_edges, device=device)
        self.source = None
        if inputs.drop_source(cell.traffic) == "online":
            self.source = OnlineDrops(cell, pool, seed, device)
            # The latest drops and picks of each batch. The render
            # capacity settles over this pass; the warm steps render at
            # it.
            self.used = [self.source(j, self.edges)
                         for j in range(pool.batches)]
        else:
            self.drops = [DropBatch(**pool.batch_drops(j))
                          for j in range(pool.batches)]
        h, w = pool.bg.shape[-3:-1]
        everything = DropBatch(**{k: v.reshape((-1,) + v.shape[2:])
                                  for k, v in self.judged().drops.items()})
        raster = fit_raster_config(everything, tuple(self.bank.raw.shape[1:]),
                                   (w, h), settings)
        render = cell.config["render"]
        self.cfg = frame.PipelineConfig(
            settings=settings, image_hw=(h, w),
            fallrate=float(cell.traffic["fallrate_mm_hr"]), raster=raster,
            save_envmap=bool(cell.traffic["save_envmap"]),
            cone_downsample=int(render["cone_downsample"]),
            fields_dtype=("bfloat16" if control == "bf16"
                          else render["fields_dtype"]))
        # PyTorch's default, no TF32, as the job runs; TF32 for its control.
        torch.backends.cuda.matmul.allow_tf32 = control == "tf32"

    def step(self, j: int):
        p = self.pool
        if self.source is None:
            return self.frame.render_frames(
                p.bg[j], p.depth[j], self.drops[j], self.bank, self.edges,
                self.cfg, tex_idx=p.tex_idx[j])
        drops, picks = self.used[j] = self.source(j, self.edges)
        return self.frame.render_frames(p.bg[j], p.depth[j], drops,
                                        self.bank, self.edges, self.cfg,
                                        tex_idx=picks)

    def drops_of(self, j: int) -> dict:
        """The drops the latest step of batch j rendered."""
        if self.source is None:
            return self.pool.batch_drops(j)
        return _fields(self.used[j][0])

    def judged(self) -> inputs.Pool:
        """The pool the judge reads: under the online source, with the
        drops and picks of each batch's latest step (each padded with
        invalid slots to the largest drop axis among them)."""
        if self.source is None:
            return self.pool
        n = max(t.shape[1] for _, t in self.used)

        def stack(ts):
            return torch.stack([torch.cat([t, t.new_zeros(
                (t.shape[0], n - t.shape[1]) + t.shape[2:])], 1)
                for t in ts])
        return dataclasses.replace(
            self.pool,
            drops={k: stack([_fields(d)[k] for d, _ in self.used])
                   for k in _fields(self.used[0][0])},
            tex_idx=stack([t for _, t in self.used]))

    def truncated(self) -> Optional[int]:
        """Drops the online source found lost to the simulation
        capacity over every step so far (None: the pool source)."""
        return None if self.source is None else int(self.source.truncated)

    def ladder(self) -> list:
        return [[b.ph, b.pw, b.radius, b.capacity, b.modes_y, b.modes_x,
                 b.ranks] for b in self.cfg.raster.buckets]


def kernels(device) -> dict:
    """Builds (on a checkout's first run) and loads the program's CUDA
    kernels: the names compiled now, and the seconds build and load
    took."""
    t = time.perf_counter()
    compiled = []
    if torch.device(device).type == "cuda":
        from raintpu_torch import cuda_build

        compiled = [n for n in KERNELS
                    if not cuda_build.library_path(n).exists()]
        cuda_build.build_all(KERNELS)
        for name in KERNELS:
            cuda_build.load(name)
    return {"compiled": compiled, "seconds": time.perf_counter() - t}


def setup(cell: spec.Cell, seed: int, device,
          control: Optional[str] = None):
    """(pool, program, kept): the program set up and warmed (kept[j] is
    batch j's output)."""
    device = torch.device(device)
    pool = inputs.make_pool(cell.config, cell.traffic, seed, device)
    prog = Program(cell, pool, device, control, seed)
    kept = [prog.step(j) for j in range(pool.batches)]
    # Once more, as every window step runs: all outputs kept and one
    # more in the making, so the allocator has grown before the window.
    kept[0] = prog.step(0)
    sync(device)
    return pool, prog, kept


@dataclasses.dataclass
class Run:
    """What the metric readers read of a run."""

    cell: spec.Cell
    device_name: str
    setup_s: float
    step_s: List[float]
    window_s: float
    frames: int
    view: Optional[trace_view.View] = None
    traced: List[StepInputs] = dataclasses.field(default_factory=list)
    profiled_steps: int = 0     # the window's first steps, profiled
    issued: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    """The closed loop's readings."""

    step_s: List[float]     # each step, start to synchronize
    seconds: float          # the window, open to close
    host_prof: object       # the profile with host operations, or None
    device_prof: object     # the profile of the device alone, or None
    device_s: float         # the device profile's steps by the host clock
    issued: dict            # kernel -> launches issued in those steps
    device_drops: list      # the drops each of those steps rendered


def launch_counts() -> dict:
    """Each counted kernel's launches so far, by the program's counter
    its count names."""
    out = {}
    for kernel in spec.counted_kernels():
        module, _, fn = spec.count(kernel).COUNTER.rpartition(".")
        out[kernel] = getattr(importlib.import_module(module), fn).launches
    return out


def window(prog: Program, kept: list, seconds: float, device,
           traced_steps: int = 0) -> Window:
    """The closed loop, opening with the two profiles of
    ``traced_steps`` steps each where that is not 0."""
    from torch.profiler import ProfilerActivity, profile

    n_p = len(kept)
    step_s = []
    cuda = device.type == "cuda"
    host_prof = device_prof = None
    device_s = 0.0
    issued = {}
    device_drops = []
    start = time.perf_counter()

    def one(i):
        t = time.perf_counter()
        kept[i % n_p] = prog.step(i % n_p)
        sync(device)
        now = time.perf_counter()
        step_s.append(now - t)
        return now

    i = 0
    if traced_steps:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as host_prof:
            for _ in range(traced_steps):
                one(i)
                i += 1
        # The device alone (on the CPU, which has none, the host).
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        before = launch_counts()
        with profile(activities=acts) as device_prof:
            t = time.perf_counter()
            for _ in range(traced_steps):
                one(i)
                device_drops.append(prog.drops_of(i % n_p))
                i += 1
            device_s = time.perf_counter() - t
        issued = {k: n - before[k] for k, n in launch_counts().items()}
    while True:
        now = one(i)
        i += 1
        if now - start >= seconds:
            break
    return Window(step_s=step_s, seconds=now - start, host_prof=host_prof,
                  device_prof=device_prof,
                  device_s=device_s, issued=issued,
                  device_drops=device_drops)


def traced_inputs(cell: spec.Cell, pool: inputs.Pool, drops: list):
    """What the kernel counts read of the traced steps that rendered
    ``drops`` (one dict of drop fields a step)."""
    h, w = pool.bg.shape[-3:-1]
    return [StepInputs(drops=d, settings=cell.config["settings"],
                       image_hw=(h, w), tex_hw=tuple(pool.textures.shape[1:]))
            for d in drops]


def _mean_ms(step_s) -> Optional[float]:
    return 1000.0 * sum(step_s) / len(step_s) if step_s else None


def read_metrics(run: Run, metrics: List[dict]) -> dict:
    """Each metric's reader over the run; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in metrics:
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, trace_name: Optional[str] = None):
    """One run. Returns (result dict, checks): the result line's keys
    but ``checks``, and the numbers compared with their limits."""
    from rainbench import check

    device = torch.device(device)
    cuda = device.type == "cuda"
    built = kernels(device)
    pool, prog, kept = setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    steps = int(cell.traffic["trace_steps"]) if trace else 0
    sampler = card.Sampler(device.index or 0) if cuda else None
    try:
        w = window(prog, kept, seconds, device, steps)
    finally:
        clocks = sampler.stop() if sampler else {"samples": 0}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    frames = len(w.step_s) * cell.batch
    r = Run(cell=cell,
            device_name=torch.cuda.get_device_name(device) if cuda else "cpu",
            setup_s=setup_s, step_s=w.step_s, window_s=w.seconds,
            frames=frames)
    if trace:
        r.view = trace_view.view(w.device_prof, steps, w.device_s)
        r.traced = traced_inputs(cell, pool, w.device_drops)
        r.profiled_steps = 2 * steps
        r.issued = w.issued
        host_view = trace_view.view(w.host_prof, steps)
        if trace_name:
            OUT_DIR.mkdir(exist_ok=True)
            w.host_prof.export_chrome_trace(
                str(OUT_DIR / f"{trace_name}.json.gz"))
        # What recording costs: the mean step untraced and in each
        # profile, and the idle share the host-recording profile reads;
        # and each counted kernel's launches in the device profile,
        # [recorded, issued].
        n = r.profiled_steps
        traced = {
            "launches": {k: [r.view.launches(spec.count(k).NAME), v]
                         for k, v in w.issued.items()},
            "step_ms_untraced": _mean_ms(w.step_s[n:]),
            "step_ms_device_profile": _mean_ms(w.step_s[steps:n]),
            "step_ms_host_profile": _mean_ms(w.step_s[:steps]),
            "device_ops_per_step_host_profile": (
                len(host_view.device_ops) / steps),
            "idle_share_host_profile": (
                100.0 * (1.0 - host_view.busy_s / host_view.window_s)
                if host_view.device_ops and host_view.window_s > 0
                else None)}
    judged, truncated = prog.judged(), prog.truncated()
    del w, prog
    verdict = check.judge(cell, judged, kept, seed, truncated)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": r.device_name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = r.view.busy_s
        dev["window_s"] = r.view.window_s
    result = {"correct": verdict.correct, "attempted": frames,
              "failed": verdict.failed,
              "metrics": read_metrics(r, cell.per_layer if trace
                                      else cell.end_to_end),
              "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": r.view.top_ops(),
                               "idle_gaps": host_view.idle_gaps()}
        result["trace"] = traced
    result["build"] = built
    result["card"] = {"name_power_limit": card.name_and_limit() if cuda
                      else "cpu", **clocks}
    return result, verdict.checks
