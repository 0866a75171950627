"""The whole render slice: the port's render_frames against raintpu's
fused render path (``_render_frames_fused(..., interpret=True)``).

Both sides get the same frames, depth, DropBatch, texture bank and
texture picks (the JAX draw, passed to the port as data). rain_mask and
rainy_image agree within atol 2e-4 — the fused path's own bar against
the XLA path (tests/test_pallas_batched.py), since the port evaluates
the kernel's formula over the XLA path's (ph, pw) windows — and the
per-rung overflow counts are equal.
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
