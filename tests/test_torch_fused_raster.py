"""The fused raster+composite: the port's plain version against the
Pallas kernels it replaces, run in interpret mode on the CPU.

The operands (params, ayc, bxc, valid counts) are raintpu's own, made by
``raintpu.render.frame.drop_fused_params`` and converted to torch; the
port's window anchor clip(minC - shift) comes from the port's prep of
the same drops. The plain version's cropped planes are held against
  K1  ``fused_raster_composite`` (one call per rung, windowed) and
  K3  ``fused_raster_composite_resident`` (all rungs in one call)
at atol 2e-4 on all five planes: the kernels evaluate the same formula
over TPU-aligned windows that differ from the port's (ph, pw) window,
as the fused path differs from the XLA path in
tests/test_pallas_batched.py.

The CUDA kernel itself is held against the plain version in
tests/test_torch_gpu.py, which runs where there is a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.data.textures import procedural_streak_database, texture_bank
from raintpu.ops import rasterize as jrz
from raintpu.ops.pallas import fused_kernel as fk
from raintpu.physics.simulator import SimConfig, simulate_frames
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

W, H, B, CAP = 96, 48, 2, 32
ATOL = 2e-4
# bench.py's hand ladder with capacities shrunk to the tiny frames: two
# strip rungs (the first pair-capable) and two full-width rungs.
LADDER = ((24, 32, 5, CAP, 12, 6, 3), (48, 32, 8, 16, 12, 6, 3),
          (96, 64, 12, 8, 24, 10, 4), (112, 96, 20, 8, 16, 8, 4))


def _configs():
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H)))
    kw = dict(settings=settings, image_hw=(H, W), fallrate=150.0,
              cone_downsample=4)
    return (jframe.PipelineConfig(raster=jrz.RasterConfig(
                buckets=tuple(jrz.BucketSpec(*b) for b in LADDER)), **kw),
            tframe.PipelineConfig(raster=trz.RasterConfig(
                buckets=tuple(trz.BucketSpec(*b) for b in LADDER)), **kw))


def _scene():
    db = procedural_streak_database()
    bank = texture_bank(db)
    sim = SimConfig(image_wh=(W, H), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=2 * CAP, z_max=5.0)
    drops = simulate_frames(jax.random.PRNGKey(4), sim,
                            jnp.full(B, 150.0), jnp.full(B, 5.0),
                            jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(1)
    bg = rng.rand(B, H, W, 3).astype(np.float32)
    depth = (rng.rand(B, H, W) * 40 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    return db, bank, drops, bg, depth, keys


@pytest.fixture(scope="module")
def operands():
    """raintpu's per-rung operands, and the port's rungs built from them."""
    jcfg, tcfg = _configs()
    db, bank, drops, bg, depth, keys = _scene()
    edges = jnp.asarray(db.bin_edges)

    def stage1(b, d, dr, k):
        _, env_photo, _ = jframe.frame_background(b, d, jcfg)
        return jframe.drop_fused_params(env_photo, dr, bank, edges, k, jcfg)

    j_rungs, _ = jax.jit(jax.vmap(stage1))(
        jnp.asarray(bg), jnp.asarray(depth), drops, keys)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)

    _, env_t, _ = tframe.frame_background(torch.as_tensor(bg),
                                          torch.as_tensor(depth), tcfg)
    t_prep, _ = tframe.drop_fused_params(
        env_t, interop.drop_batch_from_numpy(
            interop.numpy_fields(drops), device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                       device="cpu"),
        torch.as_tensor(db.bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(dtype).contiguous()

    rungs = [tfr.RasterRung(
        params=t(jr["params"]), anchor=tp.anchor, ayc=t(jr["ayc"]),
        bxc=t(jr["bxc"]),
        n_valid=t(np.asarray(jr["valid"]).sum(1), torch.int32),
        patch_hw=(b[0], b[1]))
        for jr, tp, b in zip(j_rungs, t_prep, LADDER)]
    return jcfg, tuple(bank.raw.shape[1:]), j_rungs, rungs


def _padded_hw(jcfg):
    """The JAX package's padded plane size (frame.fused_field_planes)."""
    plans = [fk.plan_window(b.ph, b.pw) for b in jcfg.raster.buckets]
    return ((H // fk.SUBLANE) * fk.SUBLANE + max(p[0] for p in plans),
            (W // fk.LANE) * fk.LANE + max(p[1] for p in plans))


def _k1(jcfg, tex_hw, jr, bspec):
    """One rung through the windowed kernel, as fused_field_planes runs
    it (strip, pair and narrow modes on), cropped to the image."""
    hp, wp = _padded_hw(jcfg)
    plan = fk.plan_window(bspec.ph, bspec.pw)
    strip = fk.bucket_strip_pad(bspec.ph, bspec.pw, bspec.radius)
    pair = strip > 0 and bspec.pw + 2 * strip <= fk.LANE // 2
    fields = jnp.zeros((B, 5, hp, wp), jnp.float32)
    out = fk.fused_raster_composite(
        jr["params"], jr["anchor"], jr["ayc"], jr["bxc"],
        jnp.sum(jr["valid"].astype(jnp.int32), axis=1), fields,
        window_hw=plan, tex_hw=tex_hw, strip_pad=strip, pair=pair,
        interpret=True, wide=jr["wide"] if strip else None)
    return np.asarray(out[..., :H, :W])


def _plain(rungs, tex_hw):
    planes = tfr.fused_raster_plain(rungs, (H, W), tex_hw)
    assert tfr.fused_raster_composite(rungs, (H, W), tex_hw).equal(planes)
    return planes.numpy()


@pytest.mark.parametrize("rung", range(len(LADDER)))
def test_plain_matches_windowed_kernel(operands, rung):
    jcfg, tex_hw, j_rungs, rungs = operands
    want = _k1(jcfg, tex_hw, j_rungs[rung], jcfg.raster.buckets[rung])
    got = _plain([rungs[rung]], tex_hw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if rung < 2:
        assert want[:, 0].sum() > 1.0, "rung must render rain"


def test_plain_matches_resident_kernel(operands):
    jcfg, tex_hw, j_rungs, rungs = operands
    hp, wp = _padded_hw(jcfg)
    want = fk.fused_raster_composite_resident(
        tuple(r["params"] for r in j_rungs),
        tuple(r["anchor"] for r in j_rungs),
        tuple(r["wide"] for r in j_rungs),
        tuple(r["ayc"] for r in j_rungs),
        tuple(r["bxc"] for r in j_rungs),
        jnp.stack([jnp.sum(r["valid"].astype(jnp.int32), axis=1)
                   for r in j_rungs], axis=1),
        n_planes=5, bspecs=jcfg.raster.buckets, tex_hw=tex_hw, hp=hp,
        wp=wp, depth=fk.resident_depth(5, hp, wp), interpret=True)
    want = np.asarray(want[..., :H, :W])
    got = _plain(rungs, tex_hw)
    assert want[:, 0].sum() > 5.0, "scene must render rain"
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_skips_invalid_slots_and_clips(operands):
    """Slots past n_valid contribute nothing, whatever they hold; window
    pixels past the image edge are dropped, not wrapped."""
    _, tex_hw, _, rungs = operands
    r = rungs[0]
    n0 = r.n_valid
    base = _plain([r], tex_hw)
    # Fill every slot past n_valid with a copy of frame 0's first drop.
    slots = torch.arange(r.params.shape[2])[None, :] >= n0[:, None]
    params = r.params.clone()
    params.permute(0, 2, 1)[slots] = r.params[0, :, 0]
    ayc, bxc, anchor = r.ayc.clone(), r.bxc.clone(), r.anchor.clone()
    for a in (ayc, bxc, anchor):
        a[slots] = a[0, 0].clone()
    filled = tfr.RasterRung(params=params, anchor=anchor, ayc=ayc,
                            bxc=bxc, n_valid=n0, patch_hw=r.patch_hw)
    np.testing.assert_array_equal(_plain([filled], tex_hw), base)
    all_valid = dataclasses.replace(
        filled, n_valid=torch.full_like(n0, params.shape[2]))
    assert _plain([all_valid], tex_hw)[:, 0].sum() > base[:, 0].sum()
    edge = r.anchor.clone()
    edge[..., 0] = W - 1
    edge[..., 1] = H - 1
    at_edge = dataclasses.replace(r, anchor=edge)
    planes = _plain([at_edge], tex_hw)
    assert np.all(planes[..., :H - 1, :] == 0)
    assert np.all(planes[..., :, :W - 1] == 0)


def test_wrapper_checks_operands(operands):
    _, tex_hw, _, rungs = operands
    r = rungs[0]
    bad = dataclasses.replace(r, anchor=r.anchor.long())
    with pytest.raises(ValueError, match="anchor"):
        tfr.fused_raster_composite([bad], (H, W), tex_hw)

