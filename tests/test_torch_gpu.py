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


def _synthetic_rung(dev, patch_hw, anchors, n_valid, seed=0):
    """A rung whose drops each cover their whole (ph, pw) window: the
    homography maps window pixel (j, i) to texture coords (j / pw,
    i / ph) + half a texel, the series is a positive bump plus noise and
    the content band spans the texture. ``anchors`` is (B, C, 2) image
    (x, y), ``n_valid`` (B,)."""
    rng = np.random.RandomState(seed)
    anchor = torch.as_tensor(np.asarray(anchors, np.int32), device=dev)
    b, c = anchor.shape[:2]
    ph, pw = patch_hw
    th, tw = TEX_HW
    params = np.zeros((b, tfr.N_PARAMS, c), np.float32)
    params[:, tfr.P_M00] = tw / pw
    params[:, tfr.P_M11] = th / ph
    params[:, tfr.P_M22] = 1.0
    params[:, tfr.P_MINCX] = anchor[..., 0].cpu().numpy()
    params[:, tfr.P_MINCY] = anchor[..., 1].cpu().numpy()
    params[:, tfr.P_SGX] = params[:, tfr.P_SGY] = 0.05
    params[:, [tfr.P_UL, tfr.P_VL]] = 0.05
    params[:, [tfr.P_UU, tfr.P_VU]] = 0.95
    params[:, tfr.P_LO] = 0.5
    params[:, tfr.P_ADDR:tfr.P_SATB + 1] = rng.rand(b, 6, c)
    ranks, my, mx = 3, 12, 6
    ayc = rng.rand(b, c, ranks, my).astype(np.float32) * 0.1
    bxc = rng.rand(b, c, ranks, mx).astype(np.float32) * 0.1
    ayc[..., 0] += 0.3
    bxc[..., 0] += 0.3
    return tfr.RasterRung(
        params=torch.as_tensor(params, device=dev),
        anchor=anchor.contiguous(), ayc=torch.as_tensor(ayc, device=dev),
        bxc=torch.as_tensor(bxc, device=dev),
        n_valid=torch.as_tensor(np.asarray(n_valid, np.int32), device=dev),
        patch_hw=patch_hw)


TEX_HW = (64, 32)
KITTI_HW = (375, 1242)
# (window, anchors (B, C, 2), n_valid, image (H, W)) for the launch
# plan's corner cases.
EDGE_CASES = {
    # One drop in the (704, 384) rung of a batch of 8 (4 chunks of 10
    # rows reach past the bottom edge, the rest exit at once).
    "lone_big_drop": ((704, 384), [[[500, 0]] * 4] * 8,
                      [1, 0, 0, 0, 0, 0, 0, 0], KITTI_HW),
    # 320 = 15 chunks of 21 rows + 5; 100 = 40 + 40 + 20.
    "ragged_last_chunk": ((320, 192), [[[10, 20], [700, 30]]] * 2,
                          [2, 1], (400, 1242)),
    "ragged_small": ((100, 41), [[[3, 5], [60, 7], [11, 40]]],
                     [3], (160, 120)),
    # Windows past the right edge, the bottom edge, both, and anchors on
    # the edges themselves (nothing inside the image).
    "edges": ((96, 64), [[[1200, 10], [100, 330], [1220, 360],
                          [1242, 0], [0, 375], [1178, 279]]],
              [6], KITTI_HW),
    # A frame with no drop between two frames with drops.
    "empty_frame": ((320, 192), [[[40, 60], [600, 100]]] * 3,
                    [2, 0, 1], KITTI_HW),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("n_planes", [5, 8])
def test_kernel_launch_plan_edges(cuda, case, n_planes):
    """The row-chunk plan's corner cases against the plain version."""
    patch_hw, anchors, n_valid, image_hw = EDGE_CASES[case]
    rung = _synthetic_rung(cuda, patch_hw, anchors, n_valid)
    before = tfr.fused_raster_composite.launches
    got = tfr.fused_raster_composite([rung], image_hw, TEX_HW, n_planes)
    want = tfr.fused_raster_plain([rung], image_hw, TEX_HW, n_planes)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == 1
    assert want[:, 0].sum() > 1.0
    for b, n in enumerate(n_valid):
        if n == 0:
            assert not want[b].any() and not got[b].any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_empty_rung_writes_nothing(cuda):
    rung = _synthetic_rung(cuda, (704, 384), [[[0, 0]] * 64] * 8, [0] * 8)
    got = tfr.fused_raster_composite([rung], KITTI_HW, TEX_HW, 8)
    torch.cuda.synchronize()
    assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ksize", [((8, 375, 1242), 25),
                                         ((3, 40, 200), 11),
                                         ((2, 9, 300), 25),
                                         ((1, 17, 130), 129),
                                         # odd W, every radius
                                         ((2, 37, 333), 11),
                                         ((2, 37, 333), 25),
                                         ((2, 37, 333), 129),
                                         # H < 2r + 1
                                         ((3, 20, 1242), 25),
                                         ((1, 60, 257), 129),
                                         # H, W not multiples of the tile
                                         ((1, 131, 259), 25),
                                         ((2, 375, 1242), 129),
                                         ((1, 200, 700), 11)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 40, 3100), (2, 3100, 37)])
@pytest.mark.parametrize("ksize", [11, 129])
def test_blur_kernel_wide_axes_every_radius(cuda, shape, ksize):
    """The 3,100-wide axis (either one) with the generic radius path,
    held against a float64 REFLECT_101 blur."""
    x = torch.rand(shape, generator=torch.Generator(device=cuda)
                   .manual_seed(1), device=cuda)
    taps = cv2_gaussian_kernel(ksize, 25.0)
    r = (ksize - 1) // 2
    got = blur_kernel.separable_blur(x, taps).cpu().numpy()
    n, h, w = shape
    xp = np.pad(x.cpu().numpy().astype(np.float64),
                ((0, 0), (r, r), (r, r)), mode="reflect")
    rows = sum(t * xp[:, i:i + h] for i, t in enumerate(taps))
    want = sum(t * rows[:, :, i:i + w] for i, t in enumerate(taps))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
