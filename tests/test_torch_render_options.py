"""The render options through the port's render_frames, against
raintpu: the 'white' and 'naive_db' strategies, streak noise and the
captured-panorama envmap (the options render_frames refused before they
were ported).

Both sides get the same frames, depth, DropBatch, texture bank, texture
picks and streak noise (raintpu's draws, passed to the port as data).
rain_mask and rainy_image agree within atol 2e-4, the envmap within
1e-5, and the per-rung overflow counts are equal.
"""

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
from torch_cpu_threads import one_torch_thread  # noqa: F401

B = 2
ATOL = 2e-4


# The render options, each against raintpu's fused path. Two rungs, of
# ranks 3 and 4 (one launch of mixed ranks on a card), keep raintpu's
# interpret-mode compile short.
OPTIONS = {"white": dict(rendering_strategy="white"),
           "naive_db": dict(rendering_strategy="naive_db"),
           "noise": dict(noise_scale=1.0, noise_std=8.0),
           "pano": dict(env_type="pano")}
OPTION_LADDER = ((24, 32, 5, 32, 12, 6, 3), (96, 64, 12, 16, 24, 10, 4))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_render_options_match_raintpu(option):
    """'white' and 'naive_db' (unit gains, no defocus), streak noise and
    the captured-panorama envmap (32x64 panos for 48x96 frames). The
    texture picks, and the noise, are raintpu's own draws (its key split
    and per-drop keys, frame.py:510-516), handed to the port as data.
    rain_mask and rainy_image within atol 2e-4, envmap within 1e-5,
    overflow equal.

    Noise and pano are held to the fused path. 'white' and 'naive_db'
    are held to raintpu's XLA path (its CPU default, held to the numpy
    oracle in tests/test_golden_parity.py): with no defocus a window is
    the content itself, and the fused path's TPU-padded windows keep the
    erf tails past the (ph, pw) window, which the XLA path and the port
    cut — the two raintpu paths differ there by ~5e-3."""
    w, h = 96, 48
    settings = dataclasses.replace(
        RenderSettings(camera=CameraSettings(wh=(w, h), ccd_wh=(w, h))),
        **OPTIONS[option])
    base = dict(settings=settings, image_hw=(h, w), fallrate=150.0,
                cone_downsample=1, save_envmap=True)
    jcfg = jframe.PipelineConfig(raster=jrz.RasterConfig(
        buckets=tuple(jrz.BucketSpec(*b) for b in OPTION_LADDER)), **base)
    tcfg = tframe.PipelineConfig(raster=trz.RasterConfig(
        buckets=tuple(trz.BucketSpec(*b) for b in OPTION_LADDER)), **base)
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    sim = SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=64, z_max=5.0)
    drops = simulate_frames(jax.random.PRNGKey(4), sim,
                            jnp.full(B, 150.0), jnp.full(B, 5.0),
                            jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(2)
    bg = rng.rand(B, h, w, 3).astype(np.float32)
    depth = (rng.rand(B, h, w) * 40 + 3).astype(np.float32)
    pano = (rng.rand(B, 32, 64, 3).astype(np.float32)
            if option == "pano" else None)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    args = (jnp.asarray(bg), jnp.asarray(depth), drops, bank, edges, keys)
    if option in ("white", "naive_db"):
        want = jframe.render_frames(*args, jcfg)
    else:
        want = jax.jit(lambda *a: jframe._render_frames_fused(
            *a[:6], jcfg, interpret=True, pano=a[6] if pano is not None
            else None))(*args, None if pano is None else jnp.asarray(pano))

    def draws(d, k):
        k_tex, k_noise = jax.random.split(k)
        nkeys = jrz.per_drop_keys(k_noise, d.ip1.shape[0], 0)
        noise = jax.vmap(lambda kk: jax.random.normal(kk, ()))(nkeys)
        return (jrz.select_textures(d, edges, k_tex),
                noise * settings.noise_std * settings.noise_scale)

    tex_idx, noise = jax.vmap(draws)(drops, keys)
    got = tframe.render_frames(
        torch.as_tensor(bg), torch.as_tensor(depth),
        interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                      device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                        device="cpu"),
        torch.as_tensor(db.bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)),
        noise_deg=(torch.as_tensor(np.array(noise)) if option == "noise"
                   else None),
        pano=None if pano is None else torch.as_tensor(pano))

    mask = got.rain_mask.numpy()
    assert mask.sum() > 1.0, "scene must render rain"
    np.testing.assert_allclose(mask, np.asarray(want.rain_mask), atol=ATOL)
    np.testing.assert_allclose(got.rainy_image.numpy(),
                               np.asarray(want.rainy_image), atol=ATOL)
    np.testing.assert_allclose(got.envmap.numpy(), np.asarray(want.envmap),
                               atol=1e-5)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    if option == "pano":
        assert np.array_equal(got.envmap.numpy(), pano)
    if option == "noise":
        assert float(np.abs(noise).max()) > 1.0


def test_render_draws_noise_after_the_texture_picks():
    """Without noise given as data, render_frames draws it from the
    generator after the texture picks: the same render as handing it
    those draws."""
    w, h = 96, 48
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)),
                              noise_scale=2.0, noise_std=3.0)
    tcfg = tframe.PipelineConfig(
        settings=settings, image_hw=(h, w), fallrate=150.0,
        raster=trz.RasterConfig(
            buckets=tuple(trz.BucketSpec(*b) for b in OPTION_LADDER)))
    gen = torch.Generator().manual_seed(3)
    ones = torch.ones(B)
    drops = tsim.simulate_frames(
        gen, tsim.SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                            exposure_s=2e-3, capacity=64, z_max=5.0),
        ones * 150.0, ones * 5.0, ones * 2e-3, ones)
    db = procedural_streak_database()
    edges = torch.as_tensor(db.bin_edges)
    args = (torch.rand(B, h, w, 3, generator=gen),
            torch.rand(B, h, w, generator=gen) * 40 + 3, drops,
            port_texture_bank(db, device="cpu"), edges, tcfg)
    drawn = tframe.render_frames(*args,
                                 generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    tex_idx = trz.select_textures(drops, edges, g)
    noise = torch.randn(drops.valid.shape, generator=g) * 6.0
    given = tframe.render_frames(*args, tex_idx=tex_idx, noise_deg=noise)
    assert torch.equal(drawn.rain_mask, given.rain_mask)
    still = tframe.render_frames(*args, tex_idx=tex_idx,
                                 noise_deg=torch.zeros_like(noise))
    assert not torch.equal(still.rain_mask, given.rain_mask)
