"""bfloat16 field planes (``PipelineConfig.fields_dtype="bfloat16"``): the
port against raintpu's windowed Pallas kernels, run in interpret mode.

raintpu rounds each drop's contribution into its bfloat16 planes, rung
after rung and slot after slot: acc = bf16(acc + c) on its full-window
and row-tile rungs (``fused_kernel._accum_rows``), acc = bf16(acc +
bf16(c)) on its strip rungs (``_accum_rows_strip``). The port's rungs
carry that rule as ``round_first``.

The scene's ladder has one rung of each kind under bfloat16 planes: a
strip rung (48x32, pair mode), A's 112x96 rung (radius 20, a full
window) and the CLI's 320x192 rung (two row tiles: K2). Both sides render
the same drops with the same texture picks, raintpu through its
``fused_field_planes(..., interpret=True)`` with its default modes
(pair_eval, row_strip, narrow_dma). Bars on the cropped planes: every
value within two bfloat16 units (2^-7·|v| + 1e-6) and at least 99.9%
of them bit-equal (the two sides' float32 contributions differ in their
last bits, which moves a rounding now and then). The plain version's
rounding is held exactly to a numpy emulation of raintpu's order and
rounding, and raintpu's own bar for bf16 against float32 (5e-3 on the
rain mask, tests/test_pallas_batched.py) holds for the port.
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

W, H, B = 256, 128, 2
LADDER = ((48, 32, 8, 48, 12, 6, 3), (112, 96, 20, 16, 16, 8, 4),
          (320, 192, 32, 4, 16, 8, 4))
# Two bfloat16 units of |v|, and the least share of bit-equal values.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-6
MIN_EQUAL = 0.999


def _configs():
    # f/2: the near drops defocus past the 112x96 rung's radius, so the
    # 320x192 rung takes some.
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H),
                                                    f_number=2.0))
    kw = dict(settings=settings, image_hw=(H, W), fallrate=150.0,
              cone_downsample=4, fields_dtype="bfloat16")
    return (jframe.PipelineConfig(raster=jrz.RasterConfig(
                buckets=tuple(jrz.BucketSpec(*b) for b in LADDER)), **kw),
            tframe.PipelineConfig(raster=trz.RasterConfig(
                buckets=tuple(trz.BucketSpec(*b) for b in LADDER)), **kw))


@pytest.fixture(scope="module")
def scene():
    """The drops, frames and texture picks, and raintpu's bfloat16
    planes of them (one interpret-mode render), cropped to the image."""
    jcfg, tcfg = _configs()
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    sim = SimConfig(image_wh=(W, H), focal_px=(600.0, 600.0),
                    exposure_s=2e-3, capacity=128, z_max=3.0)
    drops = simulate_frames(jax.random.PRNGKey(2), sim, jnp.full(B, 150.0),
                            jnp.full(B, 5.0), jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(1)
    bg = rng.rand(B, H, W, 3).astype(np.float32)
    depth = (rng.rand(B, H, W) * 40 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    _, _, planes, overflow = jax.jit(
        lambda *a: jframe.fused_field_planes(*a, jcfg, interpret=True))(
        jnp.asarray(bg), jnp.asarray(depth), drops, bank, edges, keys)
    assert planes.dtype == jnp.bfloat16
    f = jframe.crop_field_planes(planes, jcfg)
    want = np.concatenate([np.asarray(f.alpha)[:, None],
                           np.asarray(f.log_att)[:, None],
                           np.moveaxis(np.asarray(f.additive), -1, 1)], 1)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)
    port = dict(
        bg=torch.as_tensor(bg), depth=torch.as_tensor(depth),
        drops=interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                            device="cpu"),
        textures=interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                                 device="cpu"),
        bin_edges=torch.as_tensor(db.bin_edges),
        tex_idx=torch.as_tensor(np.array(tex_idx)))
    return tcfg, port, want, np.asarray(overflow)


def test_planes_match_raintpus_bf16_kernels(scene):
    cfg, port, want, overflow = scene
    _, _, planes, got_overflow = tframe.fused_field_planes(cfg=cfg, **port)
    assert planes.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_overflow.numpy(), overflow)
    got = planes.to(torch.float32).numpy()
    rungs, _ = tframe.drop_fused_params(
        tframe.frame_background(port["bg"], port["depth"], cfg)[1],
        port["drops"], port["textures"], port["bin_edges"], cfg,
        tex_idx=port["tex_idx"])
    # Each kind of rung holds drops: a strip rung, a full window, K2.
    assert [int(r.valid.sum()) > 0 for r in rungs] == [True] * 3
    assert [r.round_first for r in tframe.kernel_rungs(rungs, cfg)] == [
        True, False, False]
    assert [tfr.plan_window(b[0], b[1], 16)[3] for b in LADDER] == [1, 1, 2]

    lit = (got != 0) | (want != 0)
    equal = (got == want)[lit].mean()
    off = np.abs(got - want) - (BF16_RTOL * np.abs(want) + BF16_ATOL)
    print(f"bf16 planes: {int(lit.sum())} nonzero values, "
          f"{int((got != want).sum())} not bit-equal ({1 - equal:.2e}), "
          f"max |port-raintpu| {np.abs(got - want).max():.3g}")
    assert want[:, 0].sum() > 10.0, "the scene must render rain"
    assert (off <= 0).all(), f"{int((off > 0).sum())} values off"
    assert equal >= MIN_EQUAL


def test_bf16_render_against_float32(scene):
    cfg, port, _, _ = scene
    out16 = tframe.render_frames(cfg=cfg, **port)
    out32 = tframe.render_frames(
        cfg=dataclasses.replace(cfg, fields_dtype="float32"), **port)
    for name in ("rainy_image", "rain_mask"):
        assert getattr(out16, name).dtype == torch.float32, name
    assert out32.rain_mask.sum() > 10.0
    np.testing.assert_allclose(out16.rain_mask.numpy(),
                               out32.rain_mask.numpy(), atol=5e-3, rtol=0)
    np.testing.assert_allclose(out16.rainy_image.numpy(),
                               out32.rainy_image.numpy(), atol=5e-3, rtol=0)
    assert not torch.equal(out16.rain_mask, out32.rain_mask)
    # The golden path ignores the field.
    xla = [tframe.render_frames(cfg=dataclasses.replace(
        cfg, composite_mode="xla", fields_dtype=v), **port)
        for v in ("bfloat16", "float32")]
    for name in ("rainy_image", "rain_mask"):
        assert torch.equal(getattr(xla[0], name), getattr(xla[1], name))


@pytest.mark.parametrize("value,dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
    ("float16", torch.float32), ("bf16", torch.float32)])
def test_fields_dtype_reads_as_raintpu(value, dtype):
    """Anything but "bfloat16" is float32, as raintpu reads it."""
    _, cfg = _configs()
    assert tframe.plane_dtype(
        dataclasses.replace(cfg, fields_dtype=value)) == dtype


def _bf16(x):
    """numpy float32 -> the nearest bfloat16 (ties to even), as float32:
    the rounding of XLA's, PyTorch's and CUDA's conversions."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _overlapping_rung(round_first, seed):
    """Four drops on two frames whose (24, 32) windows overlap pairwise,
    each covering its window (tests/test_torch_gpu.py's synthetic
    drops, on (24, 32) textures), with random colours and log gains."""
    rng = np.random.RandomState(seed)
    ph, pw, c = 24, 32, 4
    r_, my, mx = 3, 12, 6
    params = np.zeros((2, tfr.N_PARAMS, c), np.float32)
    params[:, tfr.P_M00] = 1.0
    params[:, tfr.P_M11] = 1.0
    params[:, tfr.P_M22] = 1.0
    anchor = rng.randint(0, 12, (2, c, 2)).astype(np.int32)
    params[:, tfr.P_MINCX] = anchor[..., 0]
    params[:, tfr.P_MINCY] = anchor[..., 1]
    params[:, tfr.P_SGX] = 0.05
    params[:, tfr.P_SGY] = 0.05
    params[:, tfr.P_LO] = rng.uniform(0.2, 0.9, (2, c))
    for k in range(tfr.P_ADDR, tfr.P_SATB + 1):
        params[:, k] = rng.uniform(0.1, 1.7, (2, c))
    params[:, tfr.P_UL], params[:, tfr.P_UU] = 0.0, 1.0
    params[:, tfr.P_VL], params[:, tfr.P_VU] = 0.0, 1.0
    ayc = rng.uniform(0.0, 0.1, (2, c, r_, my)).astype(np.float32)
    bxc = rng.uniform(0.0, 0.1, (2, c, r_, mx)).astype(np.float32)
    ayc[..., 0, 0] += 0.6
    bxc[..., 0, 0] += 0.6
    return tfr.RasterRung(
        params=torch.as_tensor(params), anchor=torch.as_tensor(anchor),
        ayc=torch.as_tensor(ayc), bxc=torch.as_tensor(bxc),
        n_valid=torch.tensor([c, c - 1], dtype=torch.int32),
        patch_hw=(ph, pw), round_first=round_first)


def _emulate(rungs, image_hw, tex_hw, n_planes, swap=False):
    """raintpu's bfloat16 accumulation in numpy: each valid drop's
    float32 contributions (the plain version's planes of that drop
    alone), added rung after rung and slot after slot, each sum rounded
    to bfloat16, the contribution first on round_first rungs (on the
    others with ``swap``)."""
    acc = np.zeros((rungs[0].params.shape[0], n_planes) + image_hw,
                   np.float32)
    for rung in rungs:
        for s in range(rung.params.shape[2]):
            one = dataclasses.replace(
                rung, params=rung.params[:, :, s:s + 1].contiguous(),
                anchor=rung.anchor[:, s:s + 1].contiguous(),
                ayc=rung.ayc[:, s:s + 1].contiguous(),
                bxc=rung.bxc[:, s:s + 1].contiguous(),
                n_valid=torch.clamp(rung.n_valid - s, 0, 1))
            c = tfr.fused_raster_plain([one], image_hw, tex_hw,
                                       n_planes).numpy()
            if rung.round_first != swap:
                c = _bf16(c)
            acc = np.where(c != 0, _bf16(acc + c), acc)
    return acc


@pytest.mark.parametrize("n_planes", [5, 8])
def test_plain_rounds_as_raintpu(n_planes):
    image_hw, tex_hw = (40, 48), (24, 32)
    rungs = [_overlapping_rung(True, 0), _overlapping_rung(False, 1),
             _overlapping_rung(True, 2)]
    got = tfr.fused_raster_plain(rungs, image_hw, tex_hw, n_planes,
                                 dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tfr.fused_raster_composite(
        rungs, image_hw, tex_hw, n_planes, dtype=torch.bfloat16))
    got = got.to(torch.float32).numpy()
    want = _emulate(rungs, image_hw, tex_hw, n_planes)
    assert (want[:, 0] > 1.0).sum() > 50, "the drops must overlap"
    np.testing.assert_array_equal(got, want)
    # Each rule matters here: with them swapped the bits differ.
    assert (_emulate(rungs, image_hw, tex_hw, n_planes, swap=True)
            != want).any()
    f32 = tfr.fused_raster_plain(rungs, image_hw, tex_hw, n_planes).numpy()
    np.testing.assert_allclose(got, f32, rtol=2.0 ** -5, atol=1e-6)


@pytest.mark.parametrize("sublane", [8, 16])
def test_window_plan_copies_match_raintpu(sublane):
    for ph in range(1, 800, 13):
        for pw in range(1, 400, 11):
            assert tfr.plan_window(ph, pw, sublane) == fk.plan_window(
                ph, pw, sublane), (ph, pw)
            for radius in (0, 3, 5, 8, 12, 20, 32, 48):
                assert tfr.bucket_strip_pad(
                    ph, pw, radius, sublane) == fk.bucket_strip_pad(
                    ph, pw, radius, sublane), (ph, pw, radius)
