"""The fused path's per-drop prep replayed as a CUDA graph
(``render/frame.PREP_GRAPHS``, ``utils/graphs.GraphCache``), on the CPU.

The rule that engages the graph, the constants the prep makes once
(``color.device_constant``, ``photometry._cos_half_angle``) against the
expressions they replace, a CPU render that makes no graph, and the
cache's course over a pool of batches with a stand-in for
``torch.cuda.CUDAGraph`` whose replay runs the captured function again on
the graph's input buffers and writes the graph's outputs in place: the
copies in, the outputs a replay overwrites, the overflow's copy, the
keys, the profiler rule and the spans. The card's own graphs are held to
the eager render in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import color as color_ops
from raintpu_torch.ops import photometry as photometry_ops
from raintpu_torch.ops import rasterize as raster_ops
from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig
from raintpu_torch.physics.simulator import SimConfig, simulate_frames
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings
from raintpu_torch.utils import graphs, profiling
import torch_graph_stand_in
from torch_cpu_threads import one_torch_thread  # noqa: F401

W, H, B = 160, 96, 2
# Rung capacities below the drops they get, so that every batch
# overflows, each by its own counts.
LADDER = (BucketSpec(24, 32, 5, 2, 12, 6, 3),
          BucketSpec(48, 32, 8, 2, 12, 6, 3),
          BucketSpec(96, 64, 12, 2, 24, 10, 4))
CHILDREN = ("render.prep.photometry", "render.prep.geometry",
            "render.prep.rungs")


def _cfg(**kw):
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H)))
    return frame.PipelineConfig(settings=settings, image_hw=(H, W),
                                fallrate=100.0, cone_downsample=4,
                                raster=RasterConfig(buckets=LADDER), **kw)


@pytest.fixture(scope="module")
def pool():
    """Three batches of B frames, each with its own drops, frames and
    texture picks, and the texture bank."""
    gen = torch.Generator().manual_seed(3)
    sim = SimConfig(image_wh=(W, H), focal_px=(200.0, 200.0),
                    exposure_s=2e-3, capacity=64, z_max=8.0)
    ones = torch.ones(B)
    db = procedural_streak_database()
    edges = torch.as_tensor(db.bin_edges)
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        drops = simulate_frames(gen, sim, ones * 100.0, ones * 5.0,
                                ones * 2e-3, ones)
        batches.append(dict(
            bg=torch.as_tensor(rng.rand(B, H, W, 3), dtype=torch.float32),
            depth=torch.as_tensor(rng.rand(B, H, W) * 40 + 3,
                                  dtype=torch.float32),
            drops=drops,
            tex_idx=raster_ops.select_textures(drops, edges, gen)))
    return batches, texture_bank(db, device="cpu"), edges


def _render(batch, bank, edges, cfg):
    return frame.render_frames(batch["bg"], batch["depth"], batch["drops"],
                               bank, edges, cfg, tex_idx=batch["tex_idx"])


def _spans_of_last_step():
    step = profiling._step
    return {n for n, _, s, _, _ in profiling.RING if s == step}


def _outputs(out):
    return (out.rainy_image, out.rain_mask, out.overflow)


def _assert_equal(got, want):
    for g, w in zip(_outputs(got), _outputs(want)):
        assert torch.equal(g, w)


@pytest.fixture
def stand_in(monkeypatch):
    """A fresh PREP_GRAPHS that engages on the CPU, over stand-in graphs
    (``torch_graph_stand_in``): a capture runs the function on the
    graph's input buffers, and a replay runs it again there, with no
    spans, and copies the result into the outputs the capture
    returned."""
    cache = graphs.GraphCache("render.prep.replay")
    monkeypatch.setattr(frame, "PREP_GRAPHS", cache)
    monkeypatch.setattr(frame, "prep_graph_engages", lambda *a: True)
    torch_graph_stand_in.install(monkeypatch)
    return cache


@pytest.mark.parametrize("device, tex, noise, settings_noise, engages", [
    ("cuda", True, False, False, True),
    ("cuda", True, True, True, True),
    ("cuda", True, False, True, False),    # the noise would be drawn
    ("cuda", False, False, False, False),  # the texture picks would be
    ("cuda", False, True, True, False),
    ("cpu", True, False, False, False),
])
def test_engage_rule(device, tex, noise, settings_noise, engages):
    drops = types.SimpleNamespace(
        valid=types.SimpleNamespace(device=torch.device(device)))
    cfg = _cfg()
    if settings_noise:
        cfg = dataclasses.replace(cfg, settings=dataclasses.replace(
            cfg.settings, noise_scale=1.0, noise_std=2.0))
    t = torch.zeros(B, 4, dtype=torch.int64) if tex else None
    n = torch.zeros(B, 4) if noise else None
    assert frame.prep_graph_engages(drops, cfg, t, n) is engages


def test_cpu_render_makes_no_graph(pool, monkeypatch):
    batches, bank, edges = pool
    cache = graphs.GraphCache("render.prep.replay")
    monkeypatch.setattr(frame, "PREP_GRAPHS", cache)
    for batch in batches + batches[:1]:
        _render(batch, bank, edges, _cfg())
        spans = _spans_of_last_step()
        assert "render.prep.replay" not in spans
        assert set(CHILDREN) <= spans
    assert cache.captures == 0 and not cache._entries


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_are_the_expressions_they_replace(dtype, monkeypatch):
    """The color matrices and the cone's cos(fov/2), made once, and the
    photometry through them, bit for bit as each call made them."""
    gen = torch.Generator().manual_seed(5)
    rgb = torch.rand(3, 7, 11, 3, generator=gen, dtype=dtype)
    rgb[0, 0, 0] = 0.0                   # a black pixel
    env_rgb = torch.rand(2, 12, 30, 3, generator=gen, dtype=dtype)
    pos = (torch.rand(2, 40, 3, generator=gen, dtype=dtype) - 0.5) * 20.0

    def outputs():
        env = photometry_ops.env_features(env_rgb, downsample=2)
        return (color_ops.rgb_to_xyY(rgb),
                color_ops.xyY_to_rgb(color_ops.rgb_to_xyY(rgb)[1:]),
                photometry_ops.drop_colors(pos, env, fov_deg=165.0),
                photometry_ops.drop_colors(pos, env, fov_deg=120.0,
                                           irrad_type="garg"))

    cached = outputs()
    for rows in (color_ops.RGB2XYZ, color_ops.XYZ2RGB):
        made = color_ops.device_constant(rows, dtype, torch.device("cpu"))
        assert made is color_ops.device_constant(rows, dtype,
                                                 torch.device("cpu"))
        assert torch.equal(made, torch.tensor(rows, dtype=dtype))
    monkeypatch.setattr(color_ops, "device_constant",
                        lambda v, dt, dev: torch.tensor(v, dtype=dt,
                                                        device=dev))
    monkeypatch.setattr(
        photometry_ops, "_cos_half_angle",
        lambda fov, dt, dev: torch.cos(torch.deg2rad(
            torch.tensor(fov / 2.0, dtype=dt, device=dev))))
    for got, want in zip(cached, outputs()):
        assert torch.equal(got, want)


def test_replays_equal_the_eager_render(pool, stand_in):
    """Two passes over the pool: the first call runs eagerly, the second
    captures, the rest replay; every output equal to the eager render's,
    an overflow kept from an earlier step unchanged by later replays, the
    children spans only where the prep ran eagerly or was captured."""
    batches, bank, edges = pool
    cfg = _cfg()
    with pytest.MonkeyPatch.context() as eager:
        eager.setattr(frame, "prep_graph_engages", lambda *a: False)
        want = [_render(b, bank, edges, cfg) for b in batches]
    assert len({tuple(w.overflow.flatten().tolist()) for w in want}) == 3
    assert all(int(w.overflow.sum()) > 0 for w in want)
    kept = []
    for i in range(2 * len(batches)):
        out = _render(batches[i % 3], bank, edges, cfg)
        spans = _spans_of_last_step()
        assert ("render.prep.replay" in spans) is (i > 0)
        assert (set(CHILDREN) <= spans) is (i < 2)
        assert bool(set(CHILDREN) & spans) is (i < 2)
        _assert_equal(out, want[i % 3])
        kept.append(out)
    assert stand_in.captures == 1
    for i, out in enumerate(kept):
        _assert_equal(out, want[i % 3])


def test_keys_recapture_and_evict(pool, stand_in):
    """A changed PipelineConfig, texture bank or input shape is a key of
    its own: seen once, then captured; the cache keeps four keys."""
    batches, bank, edges = pool
    b0 = batches[0]
    cfg = _cfg()
    for _ in range(3):
        _render(b0, bank, edges, cfg)
    assert stand_in.captures == 1
    sat = dataclasses.replace(cfg, compute_saturation_mask=True)
    other_bank = dataclasses.replace(bank, ay=bank.ay.clone())
    one = dict(b0, bg=b0["bg"][:1], depth=b0["depth"][:1],
               drops=b0["drops"].map(lambda t: t[:1]),
               tex_idx=b0["tex_idx"][:1])
    for batch, bk, c in ((b0, bank, sat), (b0, other_bank, cfg),
                         (one, bank, cfg)):
        with pytest.MonkeyPatch.context() as eager:
            eager.setattr(frame, "prep_graph_engages", lambda *a: False)
            want = _render(batch, bk, edges, c)
        before = stand_in.captures
        _assert_equal(_render(batch, bk, edges, c), want)
        assert stand_in.captures == before
        for _ in range(2):
            _assert_equal(_render(batch, bk, edges, c), want)
        assert stand_in.captures == before + 1
    assert len(stand_in._entries) == graphs.KEYS
    # A fifth key evicts the oldest used: the first configuration's.
    _render(b0, bank, edges, dataclasses.replace(cfg, fallrate=50.0))
    assert len(stand_in._entries) == graphs.KEYS
    before = stand_in.captures
    _render(b0, bank, edges, cfg)
    _render(b0, bank, edges, cfg)
    assert stand_in.captures == before + 1


def test_no_capture_under_a_profiler(pool, stand_in):
    batches, bank, edges = pool
    cfg = _cfg()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            _render(batches[0], bank, edges, cfg)
            assert "render.prep.replay" not in _spans_of_last_step()
    assert stand_in.captures == 0
    _render(batches[0], bank, edges, cfg)
    assert stand_in.captures == 1
    # A replay under a profiler is fine.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _render(batches[1], bank, edges, cfg)
        assert "render.prep.replay" in _spans_of_last_step()
    assert stand_in.captures == 1
