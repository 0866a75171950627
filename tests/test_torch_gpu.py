"""The CUDA kernels of the port against their plain PyTorch versions.

Needs a CUDA card and nvcc: every test here is marked ``gpu`` and skips
without a card. The file imports neither jax nor the JAX package's
kernels, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur_hw
from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig
from raintpu_torch.physics.simulator import SimConfig, simulate_frames
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings

W, H, B = 320, 160, 4
LADDER = (BucketSpec(24, 32, 5, 96, 12, 6, 3),
          BucketSpec(48, 32, 8, 32, 12, 6, 3),
          BucketSpec(96, 64, 12, 16, 24, 10, 4),
          BucketSpec(112, 96, 20, 8, 16, 8, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(dev):
    settings = RenderSettings(camera=CameraSettings(wh=(W, H),
                                                    ccd_wh=(W, H)))
    cfg = frame.PipelineConfig(settings=settings, image_hw=(H, W),
                               fallrate=100.0, cone_downsample=4,
                               raster=RasterConfig(buckets=LADDER))
    gen = torch.Generator(device=dev).manual_seed(0)
    sim = SimConfig(image_wh=(W, H), focal_px=(400.0, 400.0),
                    exposure_s=2e-3, capacity=128, z_max=8.0)
    ones = torch.ones(B, device=dev)
    drops = simulate_frames(gen, sim, ones * 100.0, ones * 5.0,
                            ones * 2e-3, ones)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(B, H, W, 3), dtype=torch.float32,
                         device=dev)
    depth = torch.as_tensor(rng.rand(B, H, W) * 40 + 3,
                            dtype=torch.float32, device=dev)
    db = procedural_streak_database()
    return (cfg, gen, drops, bg, depth, texture_bank(db, device=dev),
            torch.as_tensor(db.bin_edges, device=dev))


@pytest.mark.gpu
def test_kernel_matches_plain(cuda):
    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                      generator=gen)
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    before = tfr.fused_raster_composite.launches
    got = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    want = tfr.fused_raster_plain(rungs, cfg.image_hw, tex_hw)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == len(rungs)
    assert want[:, 0].sum() > 1.0
    # The same float32 operations in the same order (the kernel is built
    # with --fmad=false): only the order of the atomic sums differs.
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_render_goes_through_the_kernel(cuda):
    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    before = tfr.fused_raster_composite.launches
    out = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                              generator=gen)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == len(LADDER)
    assert bool(torch.isfinite(out.rainy_image).all())
    assert out.rain_mask.sum().item() > 1.0


@pytest.mark.gpu
def test_multitile_kernel_matches_plain(cuda):
    """The default ladder's big rungs (2 and 5 row tiles in the JAX
    package) with the saturation planes."""
    w, h, b = 320, 160, 2
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    cfg = frame.PipelineConfig.build(settings, (h, w), 150.0,
                                     drop_capacity=64,
                                     compute_saturation_mask=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    sim = SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=128, z_max=1.0)
    ones = torch.ones(b, device=cuda)
    drops = simulate_frames(gen, sim, ones * 150.0, ones * 5.0,
                            ones * 2e-3, ones)
    rng = np.random.RandomState(0)
    bg = torch.as_tensor(rng.rand(b, h, w, 3), dtype=torch.float32,
                         device=cuda)
    depth = torch.as_tensor(rng.rand(b, h, w) * 40 + 3,
                            dtype=torch.float32, device=cuda)
    db = procedural_streak_database()
    tex = texture_bank(db, device=cuda)
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(
        env, drops, tex, torch.as_tensor(db.bin_edges, device=cuda), cfg,
        generator=gen)
    rungs = frame.kernel_rungs(prep, cfg)
    assert int(rungs[2].n_valid.sum()) > 0
    tex_hw = tuple(tex.raw.shape[1:])
    for rung in rungs:
        got = tfr.fused_raster_composite([rung], cfg.image_hw, tex_hw, 8)
        want = tfr.fused_raster_plain([rung], cfg.image_hw, tex_hw, 8)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ksize", [((8, 375, 1242), 25),
                                         ((3, 40, 200), 11),
                                         ((2, 9, 300), 25),
                                         ((1, 17, 130), 129)])
def test_blur_kernel_matches_plain(cuda, shape, ksize):
    x = torch.rand(shape, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda)
    taps = cv2_gaussian_kernel(ksize, 25.0)
    before = blur_kernel.separable_blur.launches
    got = blur_kernel.separable_blur(x, taps)
    want = separable_blur_hw(x, taps)
    torch.cuda.synchronize()
    assert blur_kernel.separable_blur.launches - before == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_blur_kernel_takes_wide_axes(cuda):
    """Axes of 3073 or more, which the plain version refuses: held
    against a float64 REFLECT_101 blur."""
    x = torch.rand((1, 40, 3100), device=cuda)
    taps = cv2_gaussian_kernel(25, 25.0)
    got = blur_kernel.separable_blur(x, taps).cpu().numpy()
    xn = x.cpu().numpy().astype(np.float64)
    xp = np.pad(xn, ((0, 0), (12, 12), (12, 12)), mode="reflect")
    rows = sum(t * xp[:, i:i + 40] for i, t in enumerate(taps))
    want = sum(t * rows[:, :, i:i + 3100] for i, t in enumerate(taps))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
