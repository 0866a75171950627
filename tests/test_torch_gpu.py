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
    assert tfr.fused_raster_composite.launches - before == 1
    assert want[:, 0].sum() > 1.0
    # The same float32 operations, summed in the same order (the kernel
    # is built with --fmad=false); cos, tanh and log round differently
    # on the card.
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_render_goes_through_the_kernel(cuda):
    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    before = tfr.fused_raster_composite.launches
    out = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                              generator=gen)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == 1
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


def _synthetic_rung(dev, patch_hw, anchors, n_valid, seed=0,
                    series=(3, 12, 6)):
    """A rung whose drops each cover their whole (ph, pw) window: the
    homography maps window pixel (j, i) to texture coords (j / pw,
    i / ph) + half a texel, the series (R, My, Mx) is a positive bump
    plus noise and the content band spans the texture. ``anchors`` is
    (B, C, 2) image (x, y), ``n_valid`` (B,)."""
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
    ranks, my, mx = series
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
TILE_H, TILE_W = tfr.TILE_HW
# More drops on one tile than the block's list holds: drawn in rounds.
CROWD = tfr.LIST_CAP + 100
# The default ladder's windows and series (R, My, Mx), as the CLI runs
# them (full rank of the bank's 6).
DEFAULT_RUNGS = (((40, 32), (6, 16, 8)), ((96, 64), (6, 24, 10)),
                 ((320, 192), (6, 16, 8)), ((704, 384), (6, 12, 6)))
# name -> ([(window, anchors (B, C, 2), n_valid (B,), series)], image
# (H, W)): the launch's corner cases, each rung a row of the table.
EDGE_CASES = {
    # One drop in the (704, 384) rung of a batch of 8, reaching past the
    # bottom edge; the other frames hold none.
    "lone_big_drop": ([((704, 384), [[[500, 0]] * 4] * 8,
                        [1, 0, 0, 0, 0, 0, 0, 0], (3, 12, 6))], KITTI_HW),
    # Windows that end inside a tile, on ragged image sizes.
    "ragged_last_chunk": ([((320, 192), [[[10, 20], [700, 30]]] * 2, [2, 1],
                         (3, 12, 6))], (400, 1242)),
    "ragged_small": ([((100, 41), [[[3, 5], [60, 7], [11, 40]]], [3],
                       (3, 12, 6))], (160, 120)),
    # Windows past the right edge, the bottom edge, both, and anchors on
    # the edges themselves (nothing inside the image).
    "edges": ([((96, 64), [[[1200, 10], [100, 330], [1220, 360],
                            [1242, 0], [0, 375], [1178, 279]]], [6],
                (3, 12, 6))], KITTI_HW),
    # A frame with no drop between two frames with drops.
    "empty_frame": ([((320, 192), [[[40, 60], [600, 100]]] * 3,
                      [2, 0, 1], (3, 12, 6))], KITTI_HW),
    # A drop straddling four tiles (one tile corner in its window).
    "four_tiles": ([((24, 32), [[[TILE_W - 16, TILE_H - 12]]], [1],
                     (3, 12, 6))], KITTI_HW),
    # CROWD overlapping drops on one tile: the list fills and the block
    # draws it in rounds; every pixel's sums stay in slot order.
    "crowded_tile": ([((24, 32), [[[(7 * i) % 96, (3 * i) % 8]
                                   for i in range(CROWD)]], [CROWD],
                       (3, 12, 6))], KITTI_HW),
    # All four default-ladder rungs in one call, each with its own
    # series; windows overlap across rungs.
    "default_ladder": ([(hw, [[[100 + 50 * k, 40 + 20 * k],
                               [600 - 40 * k, 10]]] * 2, [2, 1 + k % 2],
                         series)
                        for k, (hw, series) in enumerate(DEFAULT_RUNGS)],
                       KITTI_HW),
    # A frame whose every rung is empty, between frames with drops.
    "empty_frame_all_rungs": ([(hw, [[[30 * k, 5 * k]]] * 3, [1, 0, 1],
                                series)
                               for k, (hw, series) in
                               enumerate(DEFAULT_RUNGS[:3])], KITTI_HW),
}


def _edge_rungs(dev, case):
    specs, image_hw = EDGE_CASES[case]
    return [_synthetic_rung(dev, hw, anchors, n_valid, seed=k,
                            series=series)
            for k, (hw, anchors, n_valid, series) in enumerate(specs)
            ], image_hw


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("n_planes", [5, 8])
def test_kernel_launch_plan_edges(cuda, case, n_planes):
    """The launch's corner cases against the plain version."""
    rungs, image_hw = _edge_rungs(cuda, case)
    before = tfr.fused_raster_composite.launches
    got = tfr.fused_raster_composite(rungs, image_hw, TEX_HW, n_planes)
    want = tfr.fused_raster_plain(rungs, image_hw, TEX_HW, n_planes)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == 1
    assert want[:, 0].sum() > 1.0
    for b in range(want.shape[0]):
        if all(int(r.n_valid[b]) == 0 for r in rungs):
            assert not want[b].any() and not got[b].any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["crowded_tile", "default_ladder"])
def test_kernel_is_deterministic(cuda, case):
    """Each pixel's sums run in one fixed order: two launches on the
    same operands give the same bits."""
    rungs, image_hw = _edge_rungs(cuda, case)
    first = tfr.fused_raster_composite(rungs, image_hw, TEX_HW, 8)
    second = tfr.fused_raster_composite(rungs, image_hw, TEX_HW, 8)
    torch.cuda.synchronize()
    assert first[:, 0].sum() > 1.0
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_is_deterministic_on_a_scene(cuda):
    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                      generator=gen)
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    first = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    second = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_empty_rung_writes_nothing(cuda):
    rung = _synthetic_rung(cuda, (704, 384), [[[0, 0]] * 64] * 8, [0] * 8)
    got = tfr.fused_raster_composite([rung], KITTI_HW, TEX_HW, 8)
    torch.cuda.synchronize()
    assert not got.any()


# A fitted ladder's shape (ops.rasterize.fit_raster_config): widths
# 64 - 2 * pad and 128 - 2 * pad, series (12, 6, 3) and (24, 10, 4) /
# (16, 8, 4), so one launch mixes ranks 3 and 4; a tail rung taller than
# the scene.
FITTED = (BucketSpec(24, 50, 4, 96, 12, 6, 3),
          BucketSpec(40, 40, 8, 32, 12, 6, 3),
          BucketSpec(56, 114, 4, 24, 24, 10, 4),
          BucketSpec(368, 256, 40, 16, 16, 8, 4))
# The render options' operands: the fitted ladder, zero-sigma windows
# ('white', 'naive_db': no defocus, the window cut 0.25 past the
# content) and Small/Medium drops rotated by streak noise.
REGIMES = {"fitted": (FITTED, {}),
           "white": (LADDER, {"rendering_strategy": "white"}),
           "naive_db": (LADDER, {"rendering_strategy": "naive_db"}),
           "noise": (LADDER, {"noise_scale": 1.0, "noise_std": 8.0})}


@pytest.mark.gpu
@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("n_planes", [5, 8])
def test_kernel_matches_plain_on_render_options(cuda, regime, n_planes):
    import dataclasses

    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    ladder, options = REGIMES[regime]
    cfg = dataclasses.replace(
        cfg, raster=RasterConfig(buckets=ladder),
        settings=dataclasses.replace(cfg.settings, **options))
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                      generator=gen)
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(tex.raw.shape[1:])
    before = tfr.fused_raster_composite.launches
    got = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw, n_planes)
    want = tfr.fused_raster_plain(rungs, cfg.image_hw, tex_hw, n_planes)
    again = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw,
                                       n_planes)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == 2
    assert want[:, 0].sum() > 1.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("n_planes", [5, 8])
def test_kernel_lone_drop_fills_the_fitted_tail_rung(cuda, n_planes):
    """One drop whose window is a whole (776, 256) tail rung — past the
    bottom of a KITTI frame — beside the fitted ladder's small rungs."""
    small = [_synthetic_rung(cuda, (b.ph, b.pw), [[[90 * k, 30 * k]]], [1],
                             seed=k, series=(b.ranks, b.modes_y, b.modes_x))
             for k, b in enumerate(FITTED[:3])]
    tail = _synthetic_rung(cuda, (776, 256), [[[500, 0]]], [1], seed=9,
                           series=(4, 16, 8))
    for rungs in ([tail], small + [tail]):
        got = tfr.fused_raster_composite(rungs, KITTI_HW, TEX_HW, n_planes)
        want = tfr.fused_raster_plain(rungs, KITTI_HW, TEX_HW, n_planes)
        torch.cuda.synchronize()
        assert want[:, 0, :, 500:756].sum() > 1.0
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ksize", [((8, 375, 1242), 25),
                                         # the nuScenes fog stack and
                                         # the depth smoothing's 7 taps
                                         ((24, 900, 1600), 25),
                                         ((1, 900, 1600), 7),
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


@pytest.mark.gpu
def test_dense_depth_map_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The z-buffer (scatter_reduce amin) and the min-filter dilation on
    the card give the CPU's map bit for bit, pixels hit twice included."""
    from raintpu_torch.data.nuscenes_data import NuScenesCameraData
    from torch_nuscenes_tree import write_tree

    ds = NuScenesCameraData(write_tree(str(tmp_path / "nusc"), 2))
    for tok in ("sd_cam0", "sd_cam1"):
        got = ds.dense_depth_map(tok, device=cuda)
        want = ds.dense_depth_map(tok, device="cpu")
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_improve_depth_on_the_card(cuda):
    """smooth_depth at 900 x 1600 on the card: the 7-tap Gaussian is one
    launch of the stencil kernel, held to the CPU's plain version."""
    from raintpu_torch.tools.smooth_depth import improve_depth

    rng = np.random.RandomState(0)
    gray = (rng.rand(900, 1600) * 255).astype(np.uint8)
    gray[100:400, 200:900] = 90
    depth = (rng.rand(900, 1600) * 80 + 1).astype(np.float32)
    want = improve_depth(torch.as_tensor(gray), torch.as_tensor(depth),
                         0.001, True)
    before = blur_kernel.separable_blur.launches
    got = improve_depth(torch.as_tensor(gray, device=cuda),
                        torch.as_tensor(depth, device=cuda), 0.001, True)
    torch.cuda.synchronize()
    assert blur_kernel.separable_blur.launches - before == 1
    assert (want > 250).sum() > 10000
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_envmap_on_the_card_equals_the_cpu(cuda):
    """The full-resolution envmap of a 1600 x 900 nuScenes frame (focal
    5.5 mm): the card reads the source pixels the CPU's index map reads
    (a map computed on the card moved some by a pixel)."""
    from raintpu_torch.ops import envmap

    geom = envmap.envmap_geometry(900, 1600, 5.5)
    img = torch.rand((2, 900, 1600, 3), generator=torch.Generator()
                     .manual_seed(3))
    want = envmap.generate_envmap(img, geom)
    got = envmap.generate_envmap(img.to(cuda), geom)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def _free_address():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


@pytest.mark.gpu
def test_sharded_one_rank_nccl_equals_render_frames(cuda):
    """A one-rank nccl group's sharded render (a (1, 1) mesh: no
    collective) is render_frames, bit for bit, in one raster and one
    blur launch."""
    import torch.distributed as dist

    from raintpu_torch.ops.rasterize import select_textures
    from raintpu_torch.parallel import distributed
    from raintpu_torch.parallel import mesh as pmesh

    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    tex_idx = select_textures(drops, edges, gen)
    want = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                               tex_idx=tex_idx)
    distributed.initialize(_free_address(), 1, 0)
    try:
        mesh = pmesh.make_mesh()
        before = (tfr.fused_raster_composite.launches,
                  blur_kernel.separable_blur.launches)
        got = pmesh.render_frames_sharded(mesh, bg, depth, drops, tex, edges,
                                          cfg, tex_idx=tex_idx)
        torch.cuda.synchronize()
        after = (tfr.fused_raster_composite.launches,
                 blur_kernel.separable_blur.launches)
    finally:
        dist.destroy_process_group()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert want.rain_mask.sum() > 1.0
    for name in ("rainy_image", "rain_mask", "overflow"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.gpu
def test_sharded_two_ranks_on_the_card(cuda, tmp_path):
    """Two processes on the one card (gloo: NCCL takes one rank a GPU)
    split every frame's drops (dp 1 x sp 2) of tests/test_sharding.py's
    scene: within 1e-5 of render_frames on the card, the same alpha mass
    within a relative 1e-5 and the same overflow (the planes' sums only
    change order)."""
    import os
    import subprocess
    import sys

    from raintpu_torch import cuda_build, interop
    from raintpu_torch.ops.rasterize import select_textures
    from torch_parallel_worker import port_config, save_scene, scene

    cuda_build.build_all(("fused_raster", "separable_blur"))
    b, h, w, cap = 4, 32, 64, 16
    gen = torch.Generator().manual_seed(0)
    ones = torch.ones(b)
    drops = simulate_frames(
        gen, SimConfig(image_wh=(w, h), focal_px=(400.0, 400.0),
                       exposure_s=2e-3, capacity=cap, z_max=4.0),
        ones * 200.0, ones * 5.0, ones * 2e-3, ones)
    db = procedural_streak_database()
    bank = texture_bank(db, device="cpu")
    rng = np.random.RandomState(0)
    save_scene(tmp_path / "scene.npz", rng.rand(b, h, w, 3).astype(np.float32),
               (rng.rand(b, h, w) * 50 + 3).astype(np.float32),
               interop.numpy_fields(drops),
               (bank.raw.numpy(), bank.ay.numpy(), bank.bx.numpy()),
               db.bin_edges, select_textures(drops, torch.as_tensor(
                   db.bin_edges), gen).numpy(), cap)
    bg, depth, drops, bank, edges, tex_idx, _ = scene(tmp_path / "scene.npz",
                                                      "cuda")
    want = frame.render_frames(bg, depth, drops, bank, edges,
                               port_config(h, w, cap), tex_idx=tex_idx)
    address = _free_address()
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_parallel_worker.py")
    repo = os.path.dirname(os.path.dirname(worker))
    procs = [subprocess.Popen(
        [sys.executable, worker, address, str(r), "2", "card",
         str(tmp_path / "scene.npz"), str(tmp_path / f"card{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log
    mass = want.rain_mask.sum().item()
    assert mass > 1.0
    for r in (0, 1):
        got = np.load(tmp_path / f"card{r}.npz")
        np.testing.assert_allclose(got["mask"], want.rain_mask.cpu().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(got["image"],
                                   want.rainy_image.cpu().numpy(), atol=1e-5)
        np.testing.assert_array_equal(got["overflow"],
                                      want.overflow.cpu().numpy())
        assert abs(float(got["mask"].sum()) - mass) / mass < 1e-5


def _cutoff_flips(got, want, atol=2e-4):
    """Pixels whose rain masks differ by more than ``atol``: each must be
    a cutoff flip — one drop's alpha kept at ALPHA_CUTOFF by one path
    only, a difference of ALPHA_CUTOFF within 1e-6."""
    d = (got - want).abs()
    flips = d > atol
    assert ((d[flips] - tfr.ALPHA_CUTOFF).abs() <= 1e-6).all()
    return flips


@pytest.mark.gpu
def test_golden_path_on_the_card_matches_the_kernel(cuda):
    """composite_mode "xla" on CUDA tensors renders on the card — the
    fog's blur launch and no raster launch — within 2e-4 of the fused
    kernel on the same texture picks, the saturation mask included, but
    for at most 2 cutoff flips (the two paths round a pixel's texture
    coordinates differently)."""
    import dataclasses

    from raintpu_torch.ops.rasterize import select_textures

    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    cfg = dataclasses.replace(cfg, compute_saturation_mask=True)
    tex_idx = select_textures(drops, edges, gen)
    fused = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                                tex_idx=tex_idx)
    before = (tfr.fused_raster_composite.launches,
              blur_kernel.separable_blur.launches)
    golden = frame.render_frames(
        bg, depth, drops, tex, edges,
        dataclasses.replace(cfg, composite_mode="xla"), tex_idx=tex_idx)
    torch.cuda.synchronize()
    after = (tfr.fused_raster_composite.launches,
             blur_kernel.separable_blur.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    assert golden.rain_mask.is_cuda and golden.rain_mask.sum() > 1.0
    assert torch.equal(golden.overflow, fused.overflow)
    flips = _cutoff_flips(golden.rain_mask, fused.rain_mask)
    assert int(flips.sum()) <= 2
    for name in ("rain_mask", "rainy_image", "saturation_mask"):
        g, f = getattr(golden, name), getattr(fused, name)
        keep = ~flips.reshape(flips.shape + (1,) * (g.ndim - flips.ndim))
        assert torch.where(keep, (g - f).abs(), 0.0).max() <= 2e-4, name


@pytest.mark.gpu
def test_golden_gather_on_the_card_matches_the_cpu(cuda):
    """render_frame with texture_mode "gather" (supersample 2) on the
    card against the same render on the CPU, within the GPU-vs-CPU
    render bars of chip_smoke.py: max 5e-3, at most 1e-3 of the pixels
    off by more than 2e-4."""
    import dataclasses

    from raintpu_torch.ops.rasterize import select_textures

    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, texture_mode="gather", supersample=2))
    tex_idx = select_textures(drops, edges, gen)[0]
    one = drops.map(lambda t: t[0])
    got = frame.render_frame(bg[0], depth[0], one, tex, edges, cfg,
                             tex_idx=tex_idx)
    want = frame.render_frame(bg[0].cpu(), depth[0].cpu(), one.to("cpu"),
                              tex.to("cpu"), edges.cpu(), cfg,
                              tex_idx=tex_idx.cpu())
    assert got.rain_mask.is_cuda and want.rain_mask.sum() > 1.0
    for name in ("rain_mask", "rainy_image"):
        d = (getattr(got, name).cpu() - getattr(want, name)).abs()
        assert d.max() <= 5e-3, name
        assert (d > 2e-4).float().mean() <= 1e-3, name
