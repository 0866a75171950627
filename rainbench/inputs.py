"""The benchmark's input generator: one pool of render batches from a
seed, as a configuration and a traffic mix describe them.

Everything here is the benchmark's own, frozen with it: a later change
to the program does not move the inputs. It imports nothing of the
program. The pool holds ``pool_batches`` batches of ``batch`` frames,
made on the device with ``torch.Generator`` s seeded from the run's
seed, in a few large calls:

- frames: RGB uniform in [0, 1), depth uniform over ``depth_m`` (the
  law of the port's ``tools/bench_suite.build_scene``), at the rendered
  size: the settings' ``cam_WH`` // ``render_scale``, as the dataset
  loader resizes a frame and its depth map;
- drops: one population per frame, sampled by a copy of the port's
  per-frame simulator law (``physics/simulator.simulate_frames``: a
  Poisson count of visible drops, depth strata in proportion to their
  rates, Marshall-Palmer diameters conditioned on visibility, Atlas
  terminal velocities, motion over the exposure; projected at the
  camera's full resolution, with the sampling floor there, then
  positions and widths divided by ``render_scale`` before rounding and
  culled against the rendered frame), the simulation
  capacity sized from the expected count + 5 sigma and no truncation
  allowed, then packed to one render capacity (the largest frame's
  valid count, 128-aligned) for the whole pool;
- the camera speed of each frame: the configuration's motion schedule,
  cycled over the pool's frames and shuffled by the seed, so every seed
  renders the same set of speeds;
- the streak texture database: a copy of the procedural bank
  (``data/textures.procedural_streak_database``), seeded by the run;
- texture picks: every drop's ratio bin (count of bin edges <= its
  ratio) times 10 plus a uniform draw of 0..9, made here and handed to
  the program and the reference alike.

A traffic mix's ``drops`` key names the drop source: ``"pool"`` (the
default) makes the drops and picks above in set-up; under ``"online"``
the program simulates them inside every render step (the online job,
``rainbench/harness.OnlineDrops``), and the pool holds the frames, the
bank and the speeds alone. Frame b of pool batch j is then the job's
frame index ``j * batch + b`` (:func:`online_frames`). On a generator
seeded ``sub_seed(seed, frame)``, as the program's ``frame_generator``
seeds it, and at the job's exposure (:func:`job_exposure_s`), the law
copied here draws what the program's simulator draws, and
:func:`job_picks` what the job's picks draw, so the judge holds the
program's drops and picks to them exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Drop types of the parsed convention: Big, Medium, Small.
TYPE_BIG, TYPE_MEDIUM, TYPE_SMALL = 0, 1, 2

# Marshall-Palmer drop-size distribution and Atlas (1973) fall speed.
MP_N0 = 8000.0          # m^-3 mm^-1
DROP_D_MAX_MM = 6.0     # breakup limit
# The simulator's depth strata and frustum.
Z_MIN, Z_MAX, Z_BINS = 0.25, 30.0, 256
MIN_WIDTH_PX = 1.0
FRUSTUM_PAD = 1.3
# Procedural streak bank: canvas (TH, TW), 5 ratio bins x 10 variants.
CANVAS = (256, 32)
NUM_BINS = 5
TEXTURES_PER_BIN = 10
# Sub-seeds of one run (numpy SeedSequence([seed, STREAM])).
STREAM_SIM, STREAM_FRAMES, STREAM_PICKS, STREAM_TEXTURES, STREAM_ORDER, \
    STREAM_CHECK = range(6)
# The drop sources a traffic mix's "drops" key names.
DROP_SOURCES = ("pool", "online")
# The job seeds frame f's texture picks with seed * PICK_STRIDE + f.
PICK_STRIDE = 100003


def sub_seed(seed: int, stream: int, bits: int = 63) -> int:
    """A seed of ``bits`` bits for one stream of the run's draws."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) | (int(state[1]) << 32)) & ((1 << bits) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


# -- the simulator's law (a copy) -------------------------------------------

def _mp_lambda(rate):
    return 4.1 * torch.clamp_min(rate, 1e-3) ** (-0.21)


def _concentration_above(d_mm, rate):
    lam = _mp_lambda(rate)
    return MP_N0 / lam * torch.exp(-lam * d_mm)


@dataclasses.dataclass(frozen=True)
class Camera:
    """The simulation's view of the configuration's camera."""

    wh: tuple            # camera image (W, H), the full resolution
    focal_px: tuple      # (fx, fy) at the full resolution
    exposure_s: float
    render_scale: int = 1

    @staticmethod
    def from_settings(s: dict) -> "Camera":
        f = float(s["cam_focal"]) * 1e-3 / (float(s["cam_CCD_pixsize"])
                                            * 1e-6)
        w, h = (int(v) for v in s["cam_WH"])
        cw, ch = (int(v) for v in s["cam_CCD_WH"])
        return Camera(wh=(w, h), focal_px=(f * w / cw, f * h / ch),
                      exposure_s=float(s["cam_exposure"]) * 1e-3,
                      render_scale=int(s.get("render_scale", 1)))

    @property
    def render_wh(self) -> tuple:
        """The rendered frame (W, H): the camera's // render_scale, as
        the dataset loader resizes a frame."""
        return tuple(v // self.render_scale for v in self.wh)


def _strata(cam: Camera, rate: torch.Tensor):
    """Expected visible drops per depth stratum (..., Z_BINS) and the
    strata centres, for fall rates ``rate`` (..., 1)."""
    w, h = cam.wh
    fx, fy = cam.focal_px
    edges = torch.linspace(Z_MIN, Z_MAX, Z_BINS + 1, dtype=torch.float32,
                           device=rate.device)
    z_c = (edges[:-1] + edges[1:]) / 2.0
    dz = edges[1:] - edges[:-1]
    area = (w / fx * z_c * FRUSTUM_PAD) * (h / fy * z_c * FRUSTUM_PAD)
    d_vis_mm = MIN_WIDTH_PX * z_c / fx * 1000.0
    return area * dz * _concentration_above(d_vis_mm, rate), z_c


def expected_count(cam: Camera, fallrate: float) -> float:
    lam, _ = _strata(cam, torch.tensor([float(fallrate)]))
    return float(lam.sum())


def simulation_capacity(cam: Camera, fallrate: float) -> int:
    """The expected count + 5 sigma + 64, rounded up to 256."""
    e = expected_count(cam, fallrate)
    return int(-(-(e + 5 * math.sqrt(e) + 64) // 256) * 256)


def job_exposure_s(settings: dict, n_frames: int, device) -> torch.Tensor:
    """The online job's exposure (s) of ``n_frames`` frames, (F,)
    float32: its schedule holds the settings' ``cam_exposure`` in ms as
    float32 and multiplies by 1e-3 in float32, which can differ from
    the exposure in seconds rounded to float32 by a unit in the last
    place (5 ms: 0.0050000004)."""
    e = np.float32(settings["cam_exposure"]) * np.float32(1e-3)
    return torch.full((n_frames,), float(e), dtype=torch.float32,
                      device=device)


def simulate(gen: torch.Generator, cam: Camera, capacity: int,
             fallrate: torch.Tensor, speed_mps: torch.Tensor,
             exposure_s: Optional[torch.Tensor] = None):
    """Drop populations of F frames (fallrate, speed_mps and, where
    given, exposure_s: (F,); else the camera's exposure), in the
    renderer's parsed convention, and each frame's Poisson count before
    the capacity clamp. Returns (fields dict of (F, capacity, ...)
    tensors, count (F,))."""
    dev = fallrate.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_fr = fallrate.shape[0]
    w, h = cam.wh
    fx, fy = cam.focal_px
    n = capacity
    lam_k, z_c = _strata(cam, fallrate[:, None])
    count = torch.poisson(lam_k.sum(-1), generator=gen)
    valid = (torch.arange(n, device=dev)[None, :]
             < torch.clamp_max(count, n)[:, None])
    kidx = torch.multinomial(torch.clamp_min(lam_k, 1e-30), n,
                             replacement=True, generator=gen)
    dz = (Z_MAX - Z_MIN) / Z_BINS
    z = z_c[kidx] + (torch.rand((n_fr, n), generator=gen, **f32) - 0.5) * dz
    half_x = w / fx * z * FRUSTUM_PAD / 2.0
    half_y = h / fy * z * FRUSTUM_PAD / 2.0
    x = (torch.rand((n_fr, n), generator=gen, **f32) * 2.0 - 1.0) * half_x
    y = (torch.rand((n_fr, n), generator=gen, **f32) * 2.0 - 1.0) * half_y
    d_vis_mm = MIN_WIDTH_PX * z / fx * 1000.0
    u = torch.rand((n_fr, n), generator=gen, **f32)
    d_mm = torch.clamp_max(
        d_vis_mm - torch.log(torch.clamp_min(u, 1e-12))
        / _mp_lambda(fallrate[:, None]), DROP_D_MAX_MM)
    v_term = torch.clamp_min(9.65 - 10.3 * torch.exp(-0.6 * d_mm), 0.0)

    p1 = torch.stack([x, y, -z], -1)
    vel = torch.stack([torch.zeros_like(v_term), -v_term,
                       speed_mps[:, None].expand_as(v_term)], -1)
    p2 = p1 + vel * (cam.exposure_s if exposure_s is None
                     else exposure_s[:, None, None])

    def project(p):
        depth = torch.clamp_min(-p[..., 2], 1e-3)
        return w / 2.0 + fx * p[..., 0] / depth, \
            h / 2.0 - fy * p[..., 1] / depth, depth

    u1, v1, dep1 = project(p1)
    u2, v2, dep2 = project(p2)
    # Projected at the full resolution, then scaled to the rendered
    # frame before rounding, and culled against it.
    rs = float(cam.render_scale)
    ws, hs = w / rs, h / rs
    iw1 = fx * (d_mm * 1e-3) / dep1 / rs
    iw2 = fx * (d_mm * 1e-3) / dep2 / rs
    ip1 = torch.stack([u1 / rs, v1 / rs], -1)
    ip2 = torch.stack([u2 / rs, v2 / rs], -1)
    wp1 = torch.stack([p1[..., 0], p1[..., 1], -p1[..., 2]], -1)
    wp2 = torch.stack([p2[..., 0], p2[..., 1], -p2[..., 2]], -1)

    diff = torch.abs(ip1 - ip2)
    max_width = torch.clamp_min(torch.maximum(iw1, iw2), 0.0).to(torch.int32)
    norm = torch.clamp_min(torch.sqrt((diff * diff).sum(-1)), 1e-9)
    ratio = max_width.to(torch.float32) / norm
    ip1r, ip2r = torch.round(ip1), torch.round(ip2)
    dr = ip1r - ip2r
    length = torch.ceil(torch.sqrt((dr * dr).sum(-1))).to(torch.int32)
    m = max(hs, ws)

    def inside(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < ws)
                & (p[..., 1] >= 0) & (p[..., 1] < hs))

    valid = (valid & (max_width >= 1) & (length >= 1) & (max_width < m)
             & (length < m) & (inside(ip1r) | inside(ip2r)))
    drop_type = torch.where(
        max_width >= 4, TYPE_BIG,
        torch.where(max_width > 1, TYPE_MEDIUM, TYPE_SMALL)).to(torch.int32)
    fields = dict(ip1=ip1r, ip2=ip2r, iw1=iw1, iw2=iw2, wp1=wp1, wp2=wp2,
                  max_width=max_width, length=torch.clamp_min(length, 1),
                  ratio=ratio, drop_type=drop_type, valid=valid)
    return fields, count


def compact(fields: Dict[str, torch.Tensor], capacity: int):
    """Valid drops packed to the front (ascending index) and cut to
    ``capacity``; invalid slots keep their data with valid False."""
    valid = fields["valid"]
    n = valid.shape[-1]
    ar = torch.arange(n, device=valid.device).expand(valid.shape)
    idx = torch.sort(torch.where(valid, ar, torch.full_like(ar, n)),
                     dim=-1).values[..., :capacity]
    keep = idx < n
    idx = idx.clamp(max=n - 1)
    out = {}
    for k, a in fields.items():
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim))
        out[k] = torch.take_along_dim(a, ix, dim=idx.ndim - 1)
    out["valid"] = keep
    return out


# -- the streak texture bank (a copy of the procedural law) -----------------

def procedural_textures(seed: int):
    """(50, TH, TW) float32 textures in [0, 1], bin-major, and the (4,)
    ratio-bin edges."""
    rng = np.random.RandomState(seed)
    th, tw = CANVAS
    nominal = np.array([0.08, 0.16, 0.32, 0.64, 1.28])
    y = np.linspace(0.0, 1.0, th)[:, None]
    x = np.arange(tw, dtype=np.float64)[None, :]
    texs = []
    for b in range(NUM_BINS):
        for osc in range(TEXTURES_PER_BIN):
            n_periods = 1.0 + 0.6 * osc
            phase = rng.uniform(0, 2 * np.pi)
            amp = tw * (0.06 + 0.02 * (osc % 3))
            center = tw / 2.0 + amp * np.sin(2 * np.pi * n_periods * y + phase)
            sigma = tw * (0.10 + 0.05 * b) * (1.0 + 0.15 * np.sin(
                2 * np.pi * n_periods * y + phase + np.pi / 3))
            profile = np.exp(-((x - center) ** 2) / (2.0 * sigma ** 2))
            envelope = (np.sin(np.pi * y) ** 0.5) * (
                0.75 + 0.25 * np.cos(2 * np.pi * (n_periods * 2) * y + phase))
            tex = profile * envelope * (0.55 + 0.1 * rng.uniform())
            texs.append(np.clip(tex, 0.0, 1.0).astype(np.float32))
    edges = ((nominal[:-1] + nominal[1:]) / 2.0).astype(np.float32)
    return np.stack(texs), edges


def texture_picks(gen: torch.Generator, ratio: torch.Tensor,
                  edges: torch.Tensor) -> torch.Tensor:
    """Every drop's texture: 10 * (edges <= ratio) + uniform{0..9}."""
    bins = (ratio[..., None] >= edges).to(torch.int64).sum(-1)
    return bins * 10 + torch.randint(0, 10, ratio.shape, generator=gen,
                                     device=ratio.device)


def job_picks(seed: int, frame: int, ratio: torch.Tensor,
              edges: torch.Tensor) -> torch.Tensor:
    """Frame ``frame``'s texture picks as the job draws them: on a
    generator seeded ``seed * PICK_STRIDE + frame``, over the frame's
    (N,) drop slots."""
    gen = torch.Generator(device=ratio.device).manual_seed(
        int(seed) * PICK_STRIDE + int(frame))
    return texture_picks(gen, ratio, edges)


# -- the pool ----------------------------------------------------------------

@dataclasses.dataclass
class Pool:
    """The run's inputs: ``pool_batches`` batches of ``batch`` frames,
    leading dims (P, B)."""

    bg: torch.Tensor                 # (P, B, H, W, 3) float32
    depth: torch.Tensor              # (P, B, H, W) float32
    # (P, B, N, ...) and (P, B, N) int64; None where the program makes
    # them in its steps (the online source).
    drops: Optional[Dict[str, torch.Tensor]]
    tex_idx: Optional[torch.Tensor]
    textures: np.ndarray             # (K, TH, TW) float32
    bin_edges: np.ndarray            # (4,) float32
    speeds_mps: torch.Tensor         # (P, B)

    @property
    def batches(self) -> int:
        return self.bg.shape[0]

    def batch_drops(self, j: int) -> Dict[str, torch.Tensor]:
        return {k: v[j] for k, v in self.drops.items()}

    def frames(self, j: int, idx: Sequence[int]):
        """Frames ``idx`` of batch j: (bg, depth, drops, tex_idx)."""
        ix = torch.as_tensor(list(idx), device=self.bg.device)
        return (self.bg[j, ix], self.depth[j, ix],
                {k: v[j, ix] for k, v in self.drops.items()},
                self.tex_idx[j, ix])


def speed_schedule(config: dict) -> List[float]:
    """The configuration's camera speeds in km/h: ``motion_kmh`` as
    [start, stop, step] of numpy's arange, or one value."""
    m = config["motion_kmh"]
    if isinstance(m, (int, float)):
        return [float(m)]
    return [float(v) for v in np.arange(*m)]


def drop_source(traffic: dict) -> str:
    """The traffic mix's drop source: its ``drops`` key, "pool" where it
    has none."""
    source = traffic.get("drops", "pool")
    if source not in DROP_SOURCES:
        raise ValueError(f"drops {source!r} is not one of {DROP_SOURCES}")
    return source


def online_frames(traffic: dict, j: int) -> List[int]:
    """The job's frame indices of pool batch ``j`` under the online
    source: batch j holds frames j * batch to (j + 1) * batch - 1."""
    n_b = int(traffic["batch"])
    return list(range(j * n_b, (j + 1) * n_b))


def make_pool(config: dict, traffic: dict, seed: int, device) -> Pool:
    """The pool of a cell's run on ``device`` (see the module doc)."""
    device = torch.device(device)
    online = drop_source(traffic) == "online"
    s = config["settings"]
    cam = Camera.from_settings(s)
    w, h = cam.render_wh
    n_p, n_b = int(traffic["pool_batches"]), int(traffic["batch"])
    n_fr = n_p * n_b
    rate = float(traffic["fallrate_mm_hr"])

    sched = speed_schedule(config)
    speeds = np.resize(np.asarray(sched, np.float64), n_fr)
    order = np.random.default_rng(sub_seed(seed, STREAM_ORDER)).permutation(
        n_fr)
    speeds_mps = torch.as_tensor(speeds[order] / 3.6, dtype=torch.float32,
                                 device=device)

    if not online:
        sim_cap = simulation_capacity(cam, rate)
        fields, count = simulate(
            generator(seed, STREAM_SIM, device), cam, sim_cap,
            torch.full((n_fr,), rate, dtype=torch.float32, device=device),
            speeds_mps)
        truncated = int(torch.clamp_min(count - sim_cap, 0).sum())
        if truncated:
            raise AssertionError(f"the simulation capacity {sim_cap} "
                                 f"truncated {truncated} drops")
        most = int(fields["valid"].sum(-1).max())
        drops = compact(fields, max(128, -(-most // 128) * 128))

    gf = generator(seed, STREAM_FRAMES, device)
    bg = torch.rand((n_p, n_b, h, w, 3), generator=gf, device=device)
    lo, hi = (float(v) for v in traffic["depth_m"])
    depth = lo + (hi - lo) * torch.rand((n_p, n_b, h, w), generator=gf,
                                        device=device)

    textures, edges = procedural_textures(sub_seed(seed, STREAM_TEXTURES,
                                                   bits=32))

    def split(t):
        return t.reshape((n_p, n_b) + t.shape[1:])

    if online:
        return Pool(bg=bg, depth=depth, drops=None, tex_idx=None,
                    textures=textures, bin_edges=edges,
                    speeds_mps=split(speeds_mps))
    tex_idx = texture_picks(generator(seed, STREAM_PICKS, device),
                            drops["ratio"],
                            torch.as_tensor(edges, device=device))
    return Pool(bg=bg, depth=depth, drops={k: split(v) for k, v in
                                          drops.items()},
                tex_idx=split(tex_idx), textures=textures, bin_edges=edges,
                speeds_mps=split(speeds_mps))
