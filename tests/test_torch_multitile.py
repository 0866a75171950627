"""The multi-tile raster (K2) and the saturation planes: the port's
plain version against the Pallas kernel body it replaces.

The CLI's default ladder (``RasterConfig.default``) has two rungs whose
windows exceed MAX_SLAB_AREA, so the JAX package evaluates them with
``fused_kernel._make_kernel`` in row tiles. Here raintpu's own operands
of the (320, 192) rung — a 2-tile plan — for one frame with three drops
go through ``fused_raster_composite`` in interpret mode and through the
port's ``fused_raster_plain``, with 5 and with 8 planes, and agree within
atol 2e-4 on the image (the fused path's own bar against the XLA path,
tests/test_pallas_batched.py: the kernels evaluate TPU-aligned windows
that differ from the port's (ph, pw) window).

The port's prep of the same drops routes, compacts and fills the same
operands as raintpu's on the default ladder (full rank R = 6, modes up
to (24, 10)), saturation rows included, and the chunked plain version
equals the unchunked one to float rounding.
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
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

H, W, CAP = 128, 256, 64
RUNG = 2            # (320, 192): plan_window gives 2 row tiles
N_DROPS = 3
ATOL = 2e-4


def _configs():
    """raintpu's and the port's config of the CLI's default ladder."""
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H)))
    return tuple(m.PipelineConfig.build(settings, (H, W), 150.0,
                                        drop_capacity=CAP,
                                        compute_saturation_mask=True)
                 for m in (jframe, tframe))


@pytest.fixture(scope="module")
def operands():
    jcfg, tcfg = _configs()
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    # Near drops (z <= 1 m): heavily defocused, so some route to the
    # multi-tile rung.
    sim = SimConfig(image_wh=(W, H), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=CAP, z_max=1.0)
    drops = simulate_frames(jax.random.PRNGKey(0), sim, jnp.full(1, 150.0),
                            jnp.full(1, 5.0), jnp.full(1, 2e-3), jnp.ones(1))
    rng = np.random.RandomState(1)
    bg = rng.rand(1, H, W, 3).astype(np.float32)
    depth = (rng.rand(1, H, W) * 40 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 1)

    def stage1(b, d, dr, k):
        _, env_photo, _ = jframe.frame_background(b, d, jcfg)
        return jframe.drop_fused_params(env_photo, dr, bank, edges, k, jcfg)

    j_rungs, j_over = jax.jit(jax.vmap(stage1))(
        jnp.asarray(bg), jnp.asarray(depth), drops, keys)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)

    _, env_t, _ = tframe.frame_background(torch.as_tensor(bg),
                                          torch.as_tensor(depth), tcfg)
    t_prep, t_over = tframe.drop_fused_params(
        env_t, interop.drop_batch_from_numpy(
            interop.numpy_fields(drops), device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                        device="cpu"),
        torch.as_tensor(db.bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))
    return jcfg, tuple(bank.raw.shape[1:]), j_rungs, j_over, t_prep, t_over


def test_prep_takes_the_default_ladder(operands):
    jcfg, _, j_rungs, j_over, t_prep, t_over = operands
    np.testing.assert_array_equal(t_over.numpy(), np.asarray(j_over))
    for i, (jr, tr, b) in enumerate(zip(j_rungs, t_prep,
                                        jcfg.raster.buckets)):
        valid = np.asarray(jr["valid"])
        np.testing.assert_array_equal(tr.valid.numpy(), valid)
        np.testing.assert_array_equal(tr.drop_idx.numpy(),
                                      np.asarray(jr["drop_idx"]))
        # Full rank (ranks=0 keeps all 6) and the rung's modes.
        assert tuple(tr.ayc.shape[2:]) == (6, b.modes_y), i
        assert tuple(tr.bxc.shape[2:]) == (6, b.modes_x), i
        jp = np.moveaxis(np.asarray(jr["params"]), 1, -1)[valid]
        tp = np.moveaxis(tr.params.numpy(), 1, -1)[valid]
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=1e-5,
                                   err_msg=f"rung {i} params")
        if valid.any():
            # The saturation rows hold the drops' colors.
            assert np.all(tp[:, tfr.P_SATR:tfr.P_SATB + 1] > 0), i
        for name in ("ayc", "bxc"):
            np.testing.assert_allclose(
                getattr(tr, name).numpy()[valid],
                np.asarray(jr[name])[valid], atol=1e-5, rtol=1e-5,
                err_msg=f"rung {i} {name}")
    assert np.asarray(j_rungs[RUNG]["valid"]).sum() >= N_DROPS


def _rung(operands):
    """The multi-tile rung's operands, cut to its first N_DROPS drops:
    raintpu's params and coefficients, the port's anchors."""
    jcfg, tex_hw, j_rungs, _, t_prep, _ = operands
    jr, tp = j_rungs[RUNG], t_prep[RUNG]
    b = jcfg.raster.buckets[RUNG]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(dtype).contiguous()

    return jr, tfr.RasterRung(
        params=t(jr["params"]), anchor=tp.anchor, ayc=t(jr["ayc"]),
        bxc=t(jr["bxc"]),
        n_valid=torch.tensor([N_DROPS], dtype=torch.int32),
        patch_hw=(b.ph, b.pw)), b, tex_hw


@pytest.mark.parametrize("n_planes", [5, 8])
def test_plain_matches_multitile_kernel(operands, n_planes):
    jr, rung, b, tex_hw = _rung(operands)
    plan = fk.plan_window(b.ph, b.pw)
    assert plan[3] == 2, plan
    assert fk.bucket_strip_pad(b.ph, b.pw, b.radius) == 0
    hp = (H // fk.SUBLANE) * fk.SUBLANE + plan[0]
    wp = (W // fk.LANE) * fk.LANE + plan[1]
    want = fk.fused_raster_composite(
        jr["params"], jr["anchor"], jr["ayc"], jr["bxc"],
        jnp.full((1,), N_DROPS, jnp.int32),
        jnp.zeros((1, n_planes, hp, wp), jnp.float32), window_hw=plan,
        tex_hw=tex_hw, interpret=True)
    want = np.asarray(want[..., :H, :W])
    got = tfr.fused_raster_plain([rung], (H, W), tex_hw, n_planes)
    assert torch.equal(
        tfr.fused_raster_composite([rung], (H, W), tex_hw, n_planes), got)
    got = got.numpy()
    assert want[:, 0].sum() > 1.0, "the rung must render rain"
    if n_planes == 8:
        assert want[:, 5:].sum() > 0.1, "saturation planes must fill"
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("slots", [1, 2])
def test_chunked_plain_equals_unchunked(operands, slots):
    _, rung, b, tex_hw = _rung(operands)
    whole = tfr.fused_raster_plain([rung], (H, W), tex_hw, 8)
    chunked = tfr.fused_raster_plain([rung], (H, W), tex_hw, 8,
                                     chunk_px=slots * b.ph * b.pw)
    assert whole[:, 0].sum() > 1.0
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=0)
    # Frame chunks: two copies of the frame, one frame per chunk.
    two = dataclasses.replace(
        rung, **{f: torch.cat([getattr(rung, f)] * 2).contiguous()
                 for f in ("params", "anchor", "ayc", "bxc", "n_valid")})
    per_frame = tfr.fused_raster_plain([two], (H, W), tex_hw, 8,
                                       chunk_px=N_DROPS * b.ph * b.pw)
    torch.testing.assert_close(per_frame[0], whole[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(per_frame[1], whole[0], atol=1e-6, rtol=0)


def test_wrapper_refuses_other_plane_counts(operands):
    _, rung, _, tex_hw = _rung(operands)
    with pytest.raises(ValueError, match="n_planes"):
        tfr.fused_raster_composite([rung], (H, W), tex_hw, 6)
