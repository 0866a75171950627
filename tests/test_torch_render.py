"""The whole render slice: the port's render_frames against raintpu's
fused render path (``_render_frames_fused(..., interpret=True)``).

Both sides get the same frames, depth, DropBatch, texture bank and
texture picks (the JAX draw, passed to the port as data). rain_mask and
rainy_image agree within atol 2e-4 — the fused path's own bar against
the XLA path (tests/test_pallas_batched.py), since the port evaluates
the kernel's formula over the XLA path's (ph, pw) windows — and the
per-rung overflow counts are equal.

A render step times its stages as spans (``utils.profiling.span``):
each top-level stage once a step, in order, the prep's parts inside
render.prep, and in a CPU profile each stage a top-level host range
around the operations it issues, which trace_summary's ``stages``
attribute to it.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.data.textures import procedural_streak_database, texture_bank
from raintpu.ops import rasterize as jrz
from raintpu.physics.simulator import SimConfig, simulate_frames
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.data.textures import texture_bank as port_texture_bank
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import frame as tframe
from raintpu_torch.utils import profiling
from torch_cpu_threads import one_torch_thread  # noqa: F401

B = 2
ATOL = 2e-4


def _ladder(cap):
    """bench.py's hand ladder, capacities shrunk to the tiny frames."""
    return ((24, 32, 5, cap, 12, 6, 3), (48, 32, 8, 16, 12, 6, 3),
            (96, 64, 12, 8, 24, 10, 4), (112, 96, 20, 8, 16, 8, 4))


def _configs(w, h, cds, cap):
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    base = dict(settings=settings, image_hw=(h, w), fallrate=150.0,
                cone_downsample=cds)
    return (jframe.PipelineConfig(raster=jrz.RasterConfig(
                buckets=tuple(jrz.BucketSpec(*b) for b in _ladder(cap))),
                **base),
            tframe.PipelineConfig(raster=trz.RasterConfig(
                buckets=tuple(trz.BucketSpec(*b) for b in _ladder(cap))),
                **base))


# (192, 96) at cds 4 is large enough for env_fold to engage (the
# photometry envmap generates at 4 * 4 = 16x down, 6 texels tall);
# (96, 48) at cds 1 runs the exact, unfolded cone.
@pytest.mark.parametrize("w,h,cds,fold", [(192, 96, 4, (16, 1)),
                                          (96, 48, 1, (4, 1))])
def test_render_matches_fused_path(w, h, cds, fold):
    cap = 32
    jcfg, tcfg = _configs(w, h, cds, cap)
    assert jframe.env_downsamples(jcfg) == fold
    assert tframe.env_downsamples(tcfg) == fold
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    sim = SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=2 * cap, z_max=5.0)
    drops = simulate_frames(jax.random.PRNGKey(4), sim,
                            jnp.full(B, 150.0), jnp.full(B, 5.0),
                            jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(1)
    bg = rng.rand(B, h, w, 3).astype(np.float32)
    depth = (rng.rand(B, h, w) * 40 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    want = jax.jit(lambda *a: jframe._render_frames_fused(
        *a, jcfg, interpret=True))(jnp.asarray(bg), jnp.asarray(depth),
                                   drops, bank, edges, keys)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)
    got = tframe.render_frames(
        torch.as_tensor(bg), torch.as_tensor(depth),
        interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                      device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                        device="cpu"),
        torch.as_tensor(db.bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))

    mask = got.rain_mask.numpy()
    assert mask.shape == (B, h, w) and np.all(np.isfinite(mask))
    assert mask.sum() > 1.0, "scene must render rain"
    np.testing.assert_allclose(mask, np.asarray(want.rain_mask), atol=ATOL)
    np.testing.assert_allclose(got.rainy_image.numpy(),
                               np.asarray(want.rainy_image), atol=ATOL)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert got.envmap is None and got.saturation_mask is None


def test_render_draws_textures_from_a_generator():
    w, h = 96, 48
    _, tcfg = _configs(w, h, 4, 32)
    gen = torch.Generator().manual_seed(3)
    ones = torch.ones(B)
    drops = tsim.simulate_frames(
        gen, tsim.SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                            exposure_s=2e-3, capacity=64, z_max=5.0),
        ones * 150.0, ones * 5.0, ones * 2e-3, ones)
    db = procedural_streak_database()
    args = (torch.rand(B, h, w, 3, generator=gen),
            torch.rand(B, h, w, generator=gen) * 40 + 3, drops,
            port_texture_bank(db, device="cpu"),
            torch.as_tensor(db.bin_edges), tcfg)
    a = tframe.render_frames(*args, generator=torch.Generator().manual_seed(9))
    b = tframe.render_frames(*args, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a.rain_mask, b.rain_mask)
    assert a.rain_mask.sum() > 1.0


@pytest.mark.parametrize("field,value", [
    ("save_envmap", True), ("compute_saturation_mask", True)])
def test_render_optional_outputs(field, value):
    """save_envmap and the saturation planes add their outputs and leave
    the image and the mask as they were."""
    w, h = 96, 48
    _, tcfg = _configs(w, h, 4, 32)
    gen = torch.Generator().manual_seed(3)
    ones = torch.ones(B)
    drops = tsim.simulate_frames(
        gen, tsim.SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                            exposure_s=2e-3, capacity=64, z_max=5.0),
        ones * 150.0, ones * 5.0, ones * 2e-3, ones)
    db = procedural_streak_database()
    bg = torch.rand(B, h, w, 3, generator=gen)
    args = (bg, torch.rand(B, h, w, generator=gen) * 40 + 3, drops,
            port_texture_bank(db, device="cpu"),
            torch.as_tensor(db.bin_edges))
    tex_idx = trz.select_textures(drops, args[-1], gen)
    base = tframe.render_frames(*args, tcfg, tex_idx=tex_idx)
    got = tframe.render_frames(
        *args, dataclasses.replace(tcfg, **{field: value}), tex_idx=tex_idx)
    assert torch.equal(got.rain_mask, base.rain_mask)
    assert torch.equal(got.rainy_image, base.rainy_image)
    if field == "save_envmap":
        assert got.saturation_mask is None
        assert got.envmap.shape[:2] == (B, h) and got.envmap.shape[-1] == 3
        assert bool(((got.envmap >= 0) & (got.envmap <= 1)).all())
    else:
        assert got.envmap is None
        sat = got.saturation_mask
        assert sat.shape == (B, h, w, 3) and bool((sat >= 0).all())
        assert sat.sum() > 0
        # Each drop adds clip(alpha * color, 0, 1) only where its alpha
        # is nonzero.
        assert bool((sat.sum(-1)[base.rain_mask == 0] == 0).all())


def _spanned_scene(mode):
    """A 96x48 two-frame scene whose render opens the spans, and its
    config under composite_mode ``mode``."""
    w, h = 96, 48
    _, tcfg = _configs(w, h, 4, 32)
    gen = torch.Generator().manual_seed(3)
    ones = torch.ones(B)
    drops = tsim.simulate_frames(
        gen, tsim.SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                            exposure_s=2e-3, capacity=64, z_max=5.0),
        ones * 150.0, ones * 5.0, ones * 2e-3, ones)
    db = procedural_streak_database()
    args = (torch.rand(B, h, w, 3, generator=gen),
            torch.rand(B, h, w, generator=gen) * 40 + 3, drops,
            port_texture_bank(db, device="cpu"),
            torch.as_tensor(db.bin_edges))
    tex_idx = trz.select_textures(drops, args[-1], gen)
    return args, dataclasses.replace(tcfg, composite_mode=mode), tex_idx


PREP_PARTS = ("render.prep.photometry", "render.prep.geometry",
              "render.prep.rungs")


@pytest.mark.parametrize("mode", ["fused", "xla"])
def test_render_step_opens_each_stage_once(mode, monkeypatch):
    """Fused and golden path: one call is one render step, which opens
    each top-level stage once, in STAGES' order and with no parent, and
    the prep's three parts inside render.prep; every span carries the
    step's number."""
    monkeypatch.setattr(profiling, "RING", collections.deque(maxlen=64))
    args, cfg, tex_idx = _spanned_scene(mode)
    step = profiling.next_step() + 1
    tframe.render_frames(*args, cfg, tex_idx=tex_idx)
    spans = list(profiling.RING)
    assert {s[2] for s in spans} == {step}
    top = [s[0] for s in spans if s[1] is None]
    assert tuple(top) == tframe.STAGES
    inner = [(s[0], s[1]) for s in spans if s[1] is not None]
    assert inner == [(n, "render.prep") for n in PREP_PARTS]
    for name, _, _, t0, t1 in spans:
        assert t1 >= t0, name
    # Siblings follow one another.
    ends = [s[4] for s in spans if s[1] is None]
    starts = [s[3] for s in spans if s[1] is None]
    assert all(e <= s for e, s in zip(ends, starts[1:]))


def test_render_frame_counts_a_step(monkeypatch):
    """render_frame, the golden path's one frame, is a render step of
    its own with the same stages."""
    monkeypatch.setattr(profiling, "RING", collections.deque(maxlen=64))
    args, cfg, tex_idx = _spanned_scene("fused")
    bg, depth, drops, bank, edges = args
    step = profiling.next_step() + 1
    tframe.render_frame(bg[0], depth[0], drops.map(lambda t: t[0]), bank,
                        edges, cfg, tex_idx=tex_idx[0])
    assert profiling.next_step() == step + 1
    assert tuple(s[0] for s in profiling.RING if s[1] is None) == (
        tframe.STAGES)
    assert {s[2] for s in profiling.RING} == {step}


def test_stage_spans_in_a_cpu_profile(tmp_path):
    """Under a CPU profile each stage is a top-level host range of its
    own name, not a user annotation, around the aten operations it
    issued; trace_summary's ``stages`` give each span's operations and
    host ms a step over two steps, and account for every operation."""
    args, cfg, tex_idx = _spanned_scene("fused")
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        for _ in range(2):
            tframe.render_frames(*args, cfg, tex_idx=tex_idx)
    events = prof.events()
    spans = [e for e in events if e.name in profiling.SPAN_NAMES]
    counts = collections.Counter(e.name for e in spans)
    assert counts == {n: 2 for n in tframe.STAGES + PREP_PARTS}
    for e in spans:
        assert not e.is_user_annotation
        assert (e.cpu_parent is None) == (e.name in tframe.STAGES)
        if e.name in PREP_PARTS:
            assert e.cpu_parent.name == "render.prep"
    aten = [e for e in events if e.name.startswith("aten::")]
    assert aten
    for e in aten:
        top = e
        while top.cpu_parent is not None:
            top = top.cpu_parent
        assert top.name in tframe.STAGES, e.name
        assert top.time_range.start <= e.time_range.start
        assert e.time_range.end <= top.time_range.end

    s = profiling.trace_summary(prof)
    st = s["stages"]
    assert set(tframe.STAGES + PREP_PARTS) <= set(st)
    # A CPU profile's operations are its top-level host ranges, here the
    # stages themselves: one a stage a step, none outside a span.
    assert s["device"] == "cpu" and s["n_ops"] == 2 * len(tframe.STAGES)
    for name in tframe.STAGES:
        assert st[name]["ops"] == 1.0
        assert st[name]["busy_ms"] == pytest.approx(st[name]["host_ms"])
        assert st[name]["host_ms"] > 0
    for name in PREP_PARTS:
        assert st[name]["ops"] == 0.0 and st[name]["host_ms"] > 0
    assert sum(st["render.prep." + p]["host_ms"]
               for p in ("photometry", "geometry", "rungs")) <= (
        st["render.prep"]["host_ms"])
    assert st[profiling.OUTSIDE]["ops"] == 0.0
    assert sum(r["ops"] for r in st.values()) * 2 == s["n_ops"]
    # The idle gaps (none on a CPU timeline) are named by these ranges.
    assert {n for g in s["gaps"] for n, _ in g["host"]} <= set(tframe.STAGES)
