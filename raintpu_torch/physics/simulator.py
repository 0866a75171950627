"""Per-frame weather particle simulator, in PyTorch.

Counterpart of ``raintpu.physics.simulator`` (see its docstring for the
model): each camera frame samples the stationary drop population
directly — a Poisson count of visible drops, a depth stratum per drop
drawn in proportion to the stratum's expected visible count, a uniform
position inside the stratum and the padded frustum, and a diameter
conditioned on visibility — then projects each drop's motion over the
exposure into an image-space streak in the renderer's parsed convention.

Randomness comes from an explicit ``torch.Generator`` (on the device
the drops are made on). Its draws differ from ``jax.random``'s, so the
port's simulator is held to the JAX one by statistics only. Where the
JAX package keys a frame by ``fold_in(PRNGKey(seed), frame_idx)``, the
port gives each frame a generator of its own (:func:`frame_generator`),
so a frame's drops do not depend on the batch it is simulated in.

:func:`simulate_frames_keyed` and :func:`truncated_counts` run one
frame at a time, some two hundred small device operations a frame. Where
every generator and tensor of a call is on one CUDA device
(:func:`graph_device`), they replay that loop as a CUDA graph
(:data:`SIM_GRAPHS`, :data:`TRUNCATION_GRAPHS`), drawing from the
callers' generators' states: the same kernels on the same draws, issued
by one host call, inside the span ``sim.replay`` or
``sim.truncation.replay``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raintpu_torch import resolve_device
from raintpu_torch.particles.schema import (DropBatch, TYPE_BIG,
                                            TYPE_MEDIUM, TYPE_SMALL)
from raintpu_torch.physics import dsd
from raintpu_torch.utils import graphs

# simulate_frames_keyed's and truncated_counts' per-frame loops, captured
# as CUDA graphs: one a process for each of up to graphs.KEYS
# (SimConfig, frames, device).
SIM_GRAPHS = graphs.GraphCache("sim.replay")
TRUNCATION_GRAPHS = graphs.GraphCache("sim.truncation.replay")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters (same fields as the JAX SimConfig)."""

    image_wh: Tuple[int, int]           # camera resolution (W, H)
    focal_px: Tuple[float, float]       # focal in pixels (fx, fy)
    exposure_s: float                   # default exposure (s)
    cam_hz: float = 10.0
    capacity: int = 4096                # max drops per frame
    z_min: float = 0.25                 # nearest simulated depth (m)
    z_max: float = 30.0                 # farthest simulated depth (m)
    z_bins: int = 256                   # depth strata for importance sampling
    # Sampling floor on image width: the parse filter discards drops
    # with int(max(iw)) < 1, so sampling below 1 px only wastes capacity.
    min_width_px: float = 1.0
    frustum_pad: float = 1.3            # lateral margin factor
    render_scale: float = 1.0           # applied like the XML parse path

    @staticmethod
    def from_settings(settings, capacity: int = 4096) -> "SimConfig":
        cam = settings.camera
        fx = cam.focal * 1e-3 / (cam.ccd_pixsize * 1e-6)
        fx *= cam.wh[0] / cam.ccd_wh[0]
        fy = cam.focal * 1e-3 / (cam.ccd_pixsize * 1e-6)
        fy *= cam.wh[1] / cam.ccd_wh[1]
        return SimConfig(
            image_wh=tuple(cam.wh), focal_px=(fx, fy),
            exposure_s=cam.exposure_s, cam_hz=cam.hz, capacity=capacity,
            render_scale=float(settings.render_scale))


def _depth_grid(cfg: SimConfig, device=None):
    """Depth strata centers and widths."""
    edges = torch.linspace(cfg.z_min, cfg.z_max, cfg.z_bins + 1,
                           dtype=torch.float32, device=device)
    z_c = (edges[:-1] + edges[1:]) / 2.0
    dz = edges[1:] - edges[:-1]
    return z_c, dz


def _strata_rates(cfg: SimConfig, fallrate, device=None):
    """Expected visible-drop count per depth stratum, (..., z_bins).

    lambda_k = A(z_k) * dz * C(D >= D_vis(z_k)) where A is the (padded)
    frustum cross-section and D_vis the diameter giving min_width_px.
    ``fallrate`` may carry leading dims ending in a broadcast axis.
    """
    w, h = cfg.image_wh
    fx, fy = cfg.focal_px
    z_c, dz = _depth_grid(cfg, device)
    area = (w / fx * z_c * cfg.frustum_pad) * (h / fy * z_c * cfg.frustum_pad)
    d_vis_mm = cfg.min_width_px * z_c / fx * 1000.0
    conc = dsd.concentration_above(d_vis_mm, fallrate)  # drops / m^3
    return area * dz * conc, z_c


def expected_drop_count(cfg: SimConfig, fallrate: float) -> float:
    lam, _ = _strata_rates(cfg, fallrate)
    return float(lam.sum())


def _count_draw(generator, cfg: SimConfig, fallrate: torch.Tensor):
    """Per-stratum rates (B, K), strata centers and each frame's Poisson
    drop count (B,), unclamped: the first draw a simulation makes."""
    lam_k, z_c = _strata_rates(cfg, fallrate[:, None], fallrate.device)
    return lam_k, z_c, torch.poisson(lam_k.sum(-1), generator=generator)


def simulate_frames(generator: Optional[torch.Generator],
                    cfg: SimConfig,
                    fallrate: torch.Tensor,
                    cam_speed_mps: torch.Tensor,
                    exposure_s: torch.Tensor,
                    focal_scale: torch.Tensor) -> DropBatch:
    """Sample B camera frames' drop populations and project streaks.

    fallrate (mm/hr), cam_speed_mps (m/s forward), exposure_s (s) and
    focal_scale: (B,) float tensors on the device the drops are made
    on, which must be the generator's device. Returns a DropBatch with
    leading dim B.

    Camera frame: x right, y up (0 at camera height), z negative
    forward; the DropBatch fields come out in the renderer's parsed
    convention (image y flipped, world z negated).
    """
    device = fallrate.device
    f32 = dict(dtype=torch.float32, device=device)
    fallrate = fallrate.to(torch.float32)
    bsz = fallrate.shape[0]
    w, h = cfg.image_wh
    fx = (cfg.focal_px[0] * focal_scale.to(torch.float32))[:, None]
    fy = (cfg.focal_px[1] * focal_scale.to(torch.float32))[:, None]
    t_exp = exposure_s.to(torch.float32)[:, None, None]
    n = cfg.capacity

    lam_k, z_c, count = _count_draw(generator, cfg, fallrate)
    count = torch.clamp_max(count, n).to(torch.int32)
    valid = torch.arange(n, device=device)[None, :] < count[:, None]

    # Depth: stratum drawn in proportion to its rate + uniform inside.
    kidx = torch.multinomial(torch.clamp_min(lam_k, 1e-30), n,
                             replacement=True, generator=generator)
    dz = (cfg.z_max - cfg.z_min) / cfg.z_bins
    z = z_c[kidx] + (torch.rand((bsz, n), generator=generator, **f32)
                     - 0.5) * dz

    # Lateral position uniform in the padded frustum slab at depth z.
    half_x = w / cfg.focal_px[0] * z * cfg.frustum_pad / 2.0
    half_y = h / cfg.focal_px[1] * z * cfg.frustum_pad / 2.0
    x = (torch.rand((bsz, n), generator=generator, **f32) * 2.0
         - 1.0) * half_x
    y = (torch.rand((bsz, n), generator=generator, **f32) * 2.0
         - 1.0) * half_y

    # Diameter conditioned on visibility at this depth.
    d_vis_mm = cfg.min_width_px * z / cfg.focal_px[0] * 1000.0
    d_mm = dsd.sample_diameter_above(
        torch.rand((bsz, n), generator=generator, **f32), d_vis_mm,
        fallrate[:, None])
    v_term = dsd.terminal_velocity(d_mm)                  # m/s downward

    # Motion over the exposure: drop falls, camera advances (drops move
    # +z toward the camera in camera frame).
    p1 = torch.stack([x, y, -z], -1)                      # (B, n, 3)
    vel = torch.stack([torch.zeros_like(v_term), -v_term,
                       cam_speed_mps.to(torch.float32)[:, None]
                       .expand_as(v_term)], -1)
    p2 = p1 + vel * t_exp

    def project(p):
        depth = torch.clamp_min(-p[..., 2], 1e-3)
        u = w / 2.0 + fx * p[..., 0] / depth
        v_top = h / 2.0 - fy * p[..., 1] / depth
        return u, v_top, depth

    u1, v1t, dep1 = project(p1)
    u2, v2t, dep2 = project(p2)
    iw1 = fx * (d_mm * 1e-3) / dep1
    iw2 = fx * (d_mm * 1e-3) / dep2

    # Emit in the renderer's parsed convention: scale by render_scale,
    # negate world z, round, derive. v_top is already top-origin, so
    # the reference's y-flip of a bottom-origin sim y cancels here.
    rs = cfg.render_scale
    hs = h / rs
    ws = w / rs
    ip1 = torch.stack([u1 / rs, v1t / rs], -1)
    ip2 = torch.stack([u2 / rs, v2t / rs], -1)
    iw1 = iw1 / rs
    iw2 = iw2 / rs
    wp1 = torch.stack([p1[..., 0], p1[..., 1], -p1[..., 2]], -1)
    wp2 = torch.stack([p2[..., 0], p2[..., 1], -p2[..., 2]], -1)

    diff = torch.abs(ip1 - ip2)
    max_width = torch.clamp_min(torch.maximum(iw1, iw2), 0.0).to(
        torch.int32)
    norm = torch.clamp_min(torch.sqrt((diff * diff).sum(-1)), 1e-9)
    ratio = max_width.to(torch.float32) / norm
    ip1r = torch.round(ip1)
    ip2r = torch.round(ip2)
    dr = ip1r - ip2r
    length = torch.ceil(torch.sqrt((dr * dr).sum(-1))).to(torch.int32)

    # Degenerate filter + in-frame culling, fused as validity.
    m = max(hs, ws)

    def _in(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < ws)
                & (p[..., 1] >= 0) & (p[..., 1] < hs))

    valid = (valid & (max_width >= 1) & (length >= 1)
             & (max_width < m) & (length < m)
             & (_in(ip1r) | _in(ip2r)))

    drop_type = torch.where(
        max_width >= 4, TYPE_BIG,
        torch.where(max_width > 1, TYPE_MEDIUM, TYPE_SMALL)).to(torch.int32)

    return DropBatch(
        ip1=ip1r, ip2=ip2r, iw1=iw1, iw2=iw2, wp1=wp1, wp2=wp2,
        max_width=max_width, length=torch.clamp_min(length, 1),
        ratio=ratio, drop_type=drop_type, valid=valid)


def simulate_frame(generator: Optional[torch.Generator],
                   cfg: SimConfig,
                   fallrate: float,
                   cam_speed_mps: float,
                   exposure_s: Optional[float] = None,
                   focal_scale: float = 1.0,
                   device=None) -> DropBatch:
    """One frame of :func:`simulate_frames` (scalar settings), (N, ...),
    on ``device`` (None: the CUDA card)."""
    t_exp = cfg.exposure_s if exposure_s is None else exposure_s
    device = resolve_device(device)

    def col(v):
        return torch.full((1,), float(v), dtype=torch.float32,
                          device=device)

    out = simulate_frames(generator, cfg, col(fallrate), col(cam_speed_mps),
                          col(t_exp), col(focal_scale))
    return out.map(lambda t: t[0])


def frame_generator(seed: int, frame_idx: int, device) -> torch.Generator:
    """The generator of frame ``frame_idx``'s simulation, on ``device``:
    seeded from (seed, frame_idx) alone, as the JAX package keys a frame
    by fold_in(PRNGKey(seed), frame_idx)."""
    state = np.random.SeedSequence([seed, frame_idx]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) | (int(state[1]) << 32)) & ((1 << 63) - 1))


def stack_batches(batches: Sequence[DropBatch]) -> DropBatch:
    """The frames of ``batches``, concatenated along the batch axis."""
    return DropBatch(**{f.name: torch.cat([getattr(b, f.name)
                                           for b in batches])
                        for f in dataclasses.fields(DropBatch)})


def graph_device(generators: Sequence[Optional[torch.Generator]],
                 tensors: Sequence[torch.Tensor]) -> Optional[torch.device]:
    """The CUDA device that every one of ``generators`` and ``tensors``
    is on (a device without an index is the current one), where the
    keyed functions replay their loops as graphs; None (they run
    eagerly) where there is none, or where two of ``generators`` are one
    generator, whose draws follow one another."""
    if (not generators or any(g is None for g in generators)
            or len(set(map(id, generators))) != len(generators)):
        return None
    devices = {g.device for g in generators} | {t.device for t in tensors}
    if any(d.type != "cuda" for d in devices):
        return None
    index = {torch.cuda.current_device() if d.index is None else d.index
             for d in devices}
    return torch.device("cuda", index.pop()) if len(index) == 1 else None


def simulate_frames_keyed(generators: Sequence[torch.Generator],
                          cfg: SimConfig,
                          fallrate: torch.Tensor,
                          cam_speed_mps: torch.Tensor,
                          exposure_s: torch.Tensor,
                          focal_scale: torch.Tensor) -> DropBatch:
    """Like :func:`simulate_frames`, but frame b draws from
    ``generators[b]`` alone, so its drops equal a one-frame simulation
    on that generator whatever batch it is in. Replayed from
    :data:`SIM_GRAPHS` where :func:`graph_device`; the caller owns the
    tensors returned."""
    def simulate(gens, *cols):
        return stack_batches([
            simulate_frames(g, cfg, *(c[b:b + 1] for c in cols))
            for b, g in enumerate(gens)])

    cols = (fallrate, cam_speed_mps, exposure_s, focal_scale)
    device = graph_device(generators, cols)
    if device is None:
        return simulate(generators, *cols)
    b = len(generators)
    # simulate_frames takes every column as float32 first.
    out = SIM_GRAPHS((cfg, b, device), simulate,
                     [c[:b].to(torch.float32) for c in cols], device,
                     generators=generators)
    return out.map(torch.clone)


def truncated_count(generator: Optional[torch.Generator], cfg: SimConfig,
                    fallrate: torch.Tensor) -> torch.Tensor:
    """Drops lost to the capacity clamp of the simulation that
    ``generator`` would run at ``fallrate`` (B,): it replays that
    simulation's count draw on a generator in the same state, so the
    count is exact, not an estimate. Returns (B,) int32."""
    _, _, count = _count_draw(generator, cfg, fallrate.to(torch.float32))
    return torch.clamp_min(count - cfg.capacity, 0).to(torch.int32)


def truncated_counts(generators: Sequence[torch.Generator],
                     cfg: SimConfig, fallrate: torch.Tensor) -> torch.Tensor:
    """:func:`truncated_count` per frame, frame b on ``generators[b]``.
    Replayed from :data:`TRUNCATION_GRAPHS` where :func:`graph_device`;
    the caller owns the tensor returned."""
    def count(gens, fallrate):
        return torch.cat([truncated_count(g, cfg, fallrate[b:b + 1])
                          for b, g in enumerate(gens)])

    device = graph_device(generators, (fallrate,))
    if device is None:
        return count(generators, fallrate)
    b = len(generators)
    return TRUNCATION_GRAPHS((cfg, b, device), count,
                             [fallrate[:b].to(torch.float32)], device,
                             generators=generators).clone()


def schedule_from_settings(settings, fallrate: float,
                           n_frames: Optional[int] = None):
    """Build per-frame (fallrate, speed, exposure, focal_scale) arrays
    (numpy float32) from reference-style sim settings (normal or steps
    mode).

    In ``normal`` mode the frame count is sim_duration * cam_hz
    (``common/db.py:66``); in ``steps`` mode it is the longest schedule
    (``tools/simulation.py:375-376``), one step per camera frame.
    """
    cam = settings.camera
    sim = settings.sim
    steps = sim.steps_dict()
    if sim.mode == "steps" and steps:
        n = max(len(v) for v in steps.values())
    else:
        n = int(round(sim.duration * cam.hz))
    if n_frames is not None:
        n = n_frames

    def sched(name, default):
        vals = steps.get(name)
        if sim.mode == "steps" and vals:
            arr = np.asarray(vals, np.float32)
            # The i-th step value persists once applied (db.py:60-62).
            out = np.full((n,), arr[-1], np.float32)
            out[:min(n, len(arr))] = arr[:n]
            return out
        return np.full((n,), default, np.float32)

    fall = sched("rain_fallrate", float(fallrate))
    speed_kmh = sched("cam_motion", 0.0)
    exposure_ms = sched("cam_exposure", cam.exposure)
    focal_mm = sched("cam_focal", cam.focal)
    return fall, speed_kmh / 3.6, exposure_ms * 1e-3, focal_mm / cam.focal
