"""The CUDA kernels of the port against their plain PyTorch versions.

Needs a CUDA card and nvcc: every test here is marked ``gpu`` and skips
without a card. The file imports neither jax nor the JAX package's
kernels, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raintpu_torch import bench
from raintpu_torch.data.textures import (procedural_streak_database,
                                         texture_bank)
from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.ops import photometry as tphot
from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur_hw
from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig
from raintpu_torch.physics.simulator import SimConfig, simulate_frames
from raintpu_torch.render import frame
from raintpu_torch.render.camera import CameraSettings, RenderSettings
from raintpu_torch.tools import gpu_selfcheck, kernel_ablation

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
@pytest.mark.parametrize("operands", ["scene", "default_ladder"])
@pytest.mark.parametrize("n_planes", [5, 8])
def test_bf16_kernel_matches_plain(cuda, operands, n_planes):
    """bfloat16 planes on the scene's strip rungs (contribution rounded
    first) and its 112x96 rung, or on the default ladder's four windows
    (the two largest span many image tiles): every value within two
    bfloat16 units, at least 99.9% of the non-zero values bit-equal (the
    float32 contributions differ in their last bits), two launches
    bit-identical."""
    if operands == "scene":
        cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
        cfg = dataclasses.replace(cfg, compute_saturation_mask=True)
        _, env, _ = frame.frame_background(bg, depth, cfg)
        prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                          generator=gen)
        rungs = frame.kernel_rungs(prep, cfg)
        assert [r.round_first for r in rungs] == [True, True, True, False]
        image_hw, tex_hw = cfg.image_hw, tuple(tex.raw.shape[1:])
    else:
        (rungs, image_hw), tex_hw = _edge_rungs(cuda, operands), TEX_HW
    bf16 = torch.bfloat16
    got = tfr.fused_raster_composite(rungs, image_hw, tex_hw, n_planes,
                                     dtype=bf16)
    again = tfr.fused_raster_composite(rungs, image_hw, tex_hw, n_planes,
                                       dtype=bf16)
    want = tfr.fused_raster_plain(rungs, image_hw, tex_hw, n_planes,
                                  dtype=bf16)
    torch.cuda.synchronize()
    assert got.dtype == bf16 and torch.equal(got, again)
    g, w = got.float().cpu(), want.float().cpu()
    assert w[:, 0].sum() > 1.0
    assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-6).all())
    lit = (g != 0) | (w != 0)
    assert (g == w)[lit].float().mean().item() >= 0.999


@pytest.mark.gpu
def test_render_goes_through_the_kernel(cuda):
    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    before = (tfr.fused_raster_composite.launches,
              blur_kernel.separable_blur.launches, tphot.cone_sums.launches)
    out = frame.render_frames(bg, depth, drops, tex, edges, cfg,
                              generator=gen)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before[0] == 1
    assert blur_kernel.separable_blur.launches - before[1] == 1
    assert tphot.cone_sums.launches - before[2] == 1
    assert bool(torch.isfinite(out.rainy_image).all())
    assert out.rain_mask.sum().item() > 1.0


def _assert_near_the_cpu(got, want, frames=slice(None), skip=None):
    """The card's outputs ``got`` (cut to ``frames``) against the CPU
    render ``want`` of the same frames, every output the CPU render
    has, within the render bars of tools/gpu_selfcheck; the pixels of
    ``skip`` (B, H, W), where given, left out of the image planes."""
    for name in ("rain_mask", "rainy_image", "saturation_mask", "envmap"):
        if getattr(want, name) is None:
            continue
        d = (getattr(got, name)[frames].cpu() - getattr(want, name)).abs()
        if skip is not None and name != "envmap":
            d = d.masked_fill(skip.reshape(skip.shape + (1,) * (d.ndim - 3)),
                              0.0)
        assert d.max().item() <= gpu_selfcheck.RENDER_MAX_ABS, name
        assert ((d > gpu_selfcheck.RENDER_FAR).float().mean().item()
                <= gpu_selfcheck.RENDER_MAX_FAR_FRACTION), name


def _on_the_cpu(args, kw, frames):
    """(bg, depth, drops, bank, edges) and the draws in ``kw``, cut to
    ``frames`` and moved to the CPU."""
    bg, depth, drops, bank, edges = args
    return ((bg[frames].cpu(), depth[frames].cpu(),
             drops.map(lambda t: t[frames].cpu()), bank.to("cpu"),
             edges.cpu()),
            {k: None if v is None else v[frames].cpu() for k, v in kw.items()})


def _cpu_render(args, cfg, kw, frames):
    """render_frames of ``frames`` on the CPU, where every stage runs
    its plain version."""
    args, kw = _on_the_cpu(args, kw, frames)
    return frame.render_frames(*args, cfg, **kw)


def _kernel_rungs(args, cfg, kw):
    """The raster kernel's operands of a batch with the draws ``kw``."""
    bg, depth, drops, bank, edges = args
    _, env, _ = frame.frame_background(bg, depth, cfg, pano=kw.get("pano"))
    prep, _ = frame.drop_fused_params(env, drops, bank, edges, cfg,
                                      tex_idx=kw["tex_idx"],
                                      noise_deg=kw.get("noise_deg"))
    return frame.kernel_rungs(prep, cfg)


def _canvas_flips(card, cpu, frames, image_hw):
    """((B, H, W) windows, count) of the drops whose texture warp the
    card's operands ``card`` and the CPU's ``cpu`` of the same frames
    size differently: a streak whose (dx, dy) is a Pythagorean pair has
    a canvas width floor(th |sin| + tw |cos|) that is an integer in exact
    arithmetic, and the two devices floor it one texel apart, which
    moves its whole footprint (tools/gpu_selfcheck). Goes with that
    fault (ROADMAP 5.7)."""
    mask = torch.zeros((frames.stop - frames.start,) + tuple(image_hw),
                       dtype=torch.bool)
    count = 0
    for rc, rp in zip(card, cpu):
        assert torch.equal(rc.n_valid[frames].cpu(), rp.n_valid)
        # The homography rows, (B, 9, C).
        m = rc.params[frames, tfr.P_M00:tfr.P_M22 + 1].cpu()
        d = (m - rp.params[:, tfr.P_M00:tfr.P_M22 + 1]).abs().amax(1)
        slots = torch.arange(d.shape[1])[None, :] < rp.n_valid[:, None]
        flip = (d > 1e-3 * m.abs().amax(1)) & slots
        ph, pw = rc.patch_hw
        for b, s in torch.nonzero(flip).tolist():
            x, y = rp.anchor[b, s].tolist()
            mask[b, max(y, 0):y + ph, max(x, 0):x + pw] = True
            count += 1
    return mask, count


def _raster_matches_plain(rungs, image_hw, tex_hw, n_planes, atol=None):
    """One launch of the raster kernel over ``rungs`` within
    tools/gpu_selfcheck's kernel bar of the plain version (and within
    ``atol`` where given), and a second launch bit-identical to it."""
    before = tfr.fused_raster_composite.launches
    got = tfr.fused_raster_composite(rungs, image_hw, tex_hw, n_planes)
    launched = tfr.fused_raster_composite.launches - before
    again = tfr.fused_raster_composite(rungs, image_hw, tex_hw, n_planes)
    want = tfr.fused_raster_plain(rungs, image_hw, tex_hw, n_planes)
    torch.cuda.synchronize()
    assert launched == 1
    torch.testing.assert_close(got, want, atol=gpu_selfcheck.KERNEL_ATOL,
                               rtol=gpu_selfcheck.KERNEL_RTOL)
    if atol is not None:
        assert (got - want).abs().max().item() <= atol
    assert torch.equal(got, again)


# The render options of the CLI's jobs on KITTI frames: (settings
# changed, the ladder fitted to the drops as --raster_profile fitted
# fits it, the draw handed in besides the texture picks). A fitted case
# also computes the saturation mask and keeps the envmap.
RENDER_CASES = {"default": ({}, False, None),
                "fitted": ({}, True, None),
                "white": ({"rendering_strategy": "white"}, True, None),
                "naive_db": ({"rendering_strategy": "naive_db"}, True,
                             None),
                "noise": ({"noise_scale": 1.0, "noise_std": 1.0}, True,
                          "noise_deg"),
                "pano": ({"env_type": "pano"}, True, "pano")}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_on_the_card_equals_the_cpu(cuda, prep_graphs, case):
    """Four frames of workload A (KITTI, 10 mm/hr) rendered three times
    on the card through the fused path, the draws given as data: the
    prep runs eagerly, is captured, then replays its graph. Each render
    launches the raster and the blur kernel once, and its frames 0-1 are
    within the render bars of the CPU render; on the case's operands the
    raster kernel is within its bar of the plain version."""
    from raintpu_torch.ops.rasterize import select_textures

    options, fitted, draw = RENDER_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = bench.workload(cuda, batch=4, generator=gen)
    w = dataclasses.replace(w, cfg=dataclasses.replace(
        w.cfg, settings=dataclasses.replace(w.cfg.settings, **options)))
    if fitted:
        w = bench.fitted(w)
        w = dataclasses.replace(w, cfg=dataclasses.replace(
            w.cfg, compute_saturation_mask=True, save_envmap=True))
    kw = {"tex_idx": select_textures(w.drops, w.edges, gen)}
    if draw == "noise_deg":
        kw[draw] = torch.randn(w.drops.valid.shape, generator=gen,
                               device=cuda)
    elif draw == "pano":
        kw[draw] = w.bg.flip(1).contiguous()
    args = (w.bg, w.depth, w.drops, w.bank, w.edges)
    rungs = _kernel_rungs(args, w.cfg, kw)
    want = _cpu_render(args, w.cfg, kw, slice(0, 2))
    assert want.rain_mask.sum().item() > 1.0
    skip = None
    if options.get("rendering_strategy"):
        # No defocus smooths a canvas flip here, so RENDER_MAX_ABS, which
        # bounds one under the physics strategy, does not: the flipped
        # drops' windows are left out, at most one a frame, until the
        # floor agrees across devices (ROADMAP 5.7).
        cpu_args, cpu_kw = _on_the_cpu(args, kw, slice(0, 2))
        skip, count = _canvas_flips(
            rungs, _kernel_rungs(cpu_args, w.cfg, cpu_kw), slice(0, 2),
            w.cfg.image_hw)
        assert count <= 2
    for _ in range(3):
        before = (tfr.fused_raster_composite.launches,
                  blur_kernel.separable_blur.launches)
        out = frame.render_frames(*args, w.cfg, **kw)
        torch.cuda.synchronize()
        assert (tfr.fused_raster_composite.launches - before[0],
                blur_kernel.separable_blur.launches - before[1]) == (1, 1)
        _assert_near_the_cpu(out, want, slice(0, 2), skip)
    assert prep_graphs.captures == 1
    _raster_matches_plain(
        rungs, w.cfg.image_hw, tuple(w.bank.raw.shape[1:]),
        tfr.N_PLANES_SAT if w.cfg.compute_saturation_mask else tfr.N_PLANES)


# A render with bfloat16 planes against the float32 render of the same
# draws: the JAX package's bar between its two plane dtypes
# (tests/test_pallas_batched.py).
BF16_MASK_ATOL = 5e-3


@pytest.mark.gpu
def test_bf16_render_on_the_card_is_near_float32(cuda):
    """Workload A with bfloat16 planes (the bench's FIELDS_DTYPE=bfloat16)
    on the same texture picks as its float32 render: float32 outputs,
    the rain mask within BF16_MASK_ATOL, and not equal (the planes
    round)."""
    from raintpu_torch.ops.rasterize import select_textures

    w = bench.workload(cuda, fields_dtype="bfloat16")
    tex_idx = select_textures(w.drops, w.edges,
                              torch.Generator(device=cuda).manual_seed(3))
    args = (w.bg, w.depth, w.drops, w.bank, w.edges)
    half = frame.render_frames(*args, w.cfg, tex_idx=tex_idx)
    full = frame.render_frames(
        *args, dataclasses.replace(w.cfg, fields_dtype="float32"),
        tex_idx=tex_idx)
    torch.cuda.synchronize()
    assert half.rain_mask.dtype == half.rainy_image.dtype == torch.float32
    assert full.rain_mask.sum().item() > 1.0
    assert not torch.equal(half.rain_mask, full.rain_mask)
    assert ((half.rain_mask - full.rain_mask).abs().max().item()
            <= BF16_MASK_ATOL)


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
def test_kernel_matches_plain_on_the_rig(cuda):
    """The nuScenes rig's batch (stage_profile --nuscenes: 6 x 1600x900
    at 100 mm/hr, the whole population, a fitted ladder whose tail rung
    spans many image tiles): no drop overflows, and the raster kernel
    is within its bar of the plain version on each rung alone and on all
    rungs in one launch."""
    from raintpu_torch.tools import stage_profile

    w = stage_profile.workload(stage_profile.parse_args(
        ["--nuscenes", "--device", "cuda"]))
    cfg = w["cfg"]
    _, env, _ = frame.frame_background(w["bg"], w["depth"], cfg)
    prep, overflow = frame.drop_fused_params(
        env, w["drops"], w["tex"], w["edges"], cfg,
        generator=torch.Generator(device=cuda).manual_seed(1))
    assert int(overflow.sum()) == 0
    rungs = frame.kernel_rungs(prep, cfg)
    tex_hw = tuple(w["tex"].raw.shape[1:])
    for sub in [[r] for r in rungs] + [rungs]:
        _raster_matches_plain(sub, cfg.image_hw, tex_hw, tfr.N_PLANES)
    assert sum(int(r.n_valid.sum()) for r in rungs) > 6 * 1000


@pytest.mark.gpu
def test_rig_frame_on_the_card_equals_the_cpu(cuda):
    """Frame 0 of the nuScenes rig's batch at 100 mm/hr (the density of
    the nuscenes-100mm cell), rendered on the card with the rest of its
    batch, within the render bars of the CPU render of that frame on the
    same drops and texture picks."""
    from raintpu_torch.ops.rasterize import select_textures
    from raintpu_torch.tools import stage_profile

    w = stage_profile.workload(stage_profile.parse_args(
        ["--nuscenes", "--device", "cuda"]))
    cfg = w["cfg"]
    args = (w["bg"], w["depth"], w["drops"], w["tex"], w["edges"])
    kw = {"tex_idx": select_textures(
        w["drops"], w["edges"], torch.Generator(device=cuda).manual_seed(1))}
    out = frame.render_frames(*args, cfg, **kw)
    want = _cpu_render(args, cfg, kw, slice(0, 1))
    assert int(w["drops"].count()[0]) > 1000
    assert want.rain_mask.sum().item() > 1.0
    _assert_near_the_cpu(out, want, slice(0, 1))


# The blur kernel against its plain version: the same products summed
# in another order.
BLUR_ATOL = 1e-5
# tools/bench_suite's configurations whose fitted ladders no other card
# test runs, at their published sizes (bench_kitti_sweep and
# bench_cityscapes_envmap): batch, W, H, fall rate (mm/hr) and the
# render's options.
SUITE_SCENES = {**{f"kitti_sweep-{r}mm": (12, 1242, 375, r, {})
                   for r in (1, 5, 25, 50)},
                "cityscapes_envmap": (12, 1024, 512, 25,
                                      {"save_envmap": True})}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SUITE_SCENES))
def test_kernel_matches_plain_on_the_suite(cuda, monkeypatch, name):
    """A scene of tools/bench_suite as its configuration builds it: the
    whole population simulated (nothing truncated) and no drop over its
    fitted ladder's capacities; on the draws of its step 0 the raster
    kernel is within its bar of the plain version on all rungs in one
    launch, two launches bit-identical, and the blur kernel within
    BLUR_ATOL of its plain version on the scene's fog stack."""
    from raintpu_torch.ops import fog
    from raintpu_torch.physics.simulator import frame_generator
    from raintpu_torch.tools import bench_suite

    b, w, h, rate, options = SUITE_SCENES[name]
    sc = bench_suite._common(b, w, h, rate, device=cuda, **options)
    assert sc.truncated == 0
    stacks, blur = [], fog.separable_blur

    def recorded_blur(x, taps):
        stacks.append((x, taps))
        return blur(x, taps)

    monkeypatch.setattr(fog, "separable_blur", recorded_blur)
    _, env, _ = frame.frame_background(sc.bg, sc.depth, sc.cfg)
    prep, overflow = frame.drop_fused_params(
        env, sc.drops, sc.bank, sc.edges, sc.cfg,
        generator=frame_generator(bench_suite.DRAW_SEED, 0, cuda))
    assert int(overflow.sum()) == 0
    rungs = frame.kernel_rungs(prep, sc.cfg)
    assert sum(int(r.n_valid.sum()) for r in rungs) > 0
    _raster_matches_plain(rungs, sc.cfg.image_hw,
                          tuple(sc.bank.raw.shape[1:]), tfr.N_PLANES)
    (x, taps), = stacks
    assert tuple(x.shape) == (4 * b, h, w)
    d = blur_kernel.separable_blur(x, taps) - separable_blur_hw(x, taps)
    assert d.abs().max().item() <= BLUR_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ksize", [((8, 375, 1242), 25),
                                         # the nuScenes fog stack and
                                         # the depth smoothing's 7 taps
                                         ((24, 900, 1600), 25),
                                         ((1, 900, 1600), 7),
                                         # the Cityscapes fog stack
                                         ((48, 512, 1024), 25),
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
    """Axes of 3073 or more, where the plain version takes block slabs:
    held against a float64 REFLECT_101 blur."""
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


# The cone sums' shapes: frames, the photometry envmap (h, w) at
# cone_downsample 4 (its texel blocks: KITTI 23 x 117 = 2,691, the
# nuScenes rig 56 x 149 = 8,344, Cityscapes 31 x 97 = 3,007; KITTI at
# cone_downsample 1, 93 x 477 = 44,361) and the render capacity N.
CONE_CASES = {"kitti": (48, (23, 117), 320),
              "rig": (6, (56, 149), 3200),
              "rig_slice": (1, (56, 149), 16000),
              "cityscapes": (48, (31, 97), 768),
              "kitti_cds1": (8, (93, 477), 320)}
# Bars on the sums with real features, per drop and column, as a share
# of the drop's solid-angle sum. Against the plain mask's sums in
# float64 the kernel sums a tile (256 texel blocks) and then the tiles'
# sums, so its error barely grows with Q (at most 1.22e-6 at every
# shape on an H100): CONE_RTOL_F64. Against the plain
# version the bar is that version's own error, one sequential float32 sum
# of Q terms a drop in its matrix product, which grows as sqrt(Q)
# roundings of 2^-24 (0.9-1.9 of them measured, 2.4e-5 at KITTI's 44,361
# texels at cone_downsample 1): cone_rtol(Q), four of them.
CONE_RTOL_F64 = 4e-6


def cone_rtol(q):
    return 4.0 * q ** 0.5 * 2.0 ** -24


def _cone_inputs(dev, frames, env_hw, n, seed=0):
    """(p, n, env, cos_t) as drop_fov_stats makes them, for ``n`` drops
    a frame spread around the camera (from 3 drops on, the first at the
    origin and the second far outside the sphere, its cone facing away
    from the map), over a random envmap of ``env_hw``; ``frames`` 0: no
    frame axis."""
    rng = np.random.RandomState(seed)
    lead = (frames,) if frames else ()
    mid = np.stack([rng.uniform(-4, 4, lead + (n,)),
                    rng.uniform(-2, 3, lead + (n,)),
                    rng.uniform(0.3, 20, lead + (n,))], -1)
    if n > 2:
        mid[..., 0, :] = 0.0
        mid[..., 1, :] = (3.0, -2.0, 60.0)
    env = tphot.env_features(torch.as_tensor(
        rng.rand(*lead, *env_hw, 3), dtype=torch.float32, device=dev),
        downsample=1)
    p = tphot.swap_yz(torch.as_tensor(mid, dtype=torch.float32, device=dev))
    nrm = p / torch.clamp_min(torch.sqrt((p * p).sum(-1, keepdim=True)),
                              1e-12)
    return p, nrm, env, tphot._cos_half_angle(82.5, torch.float32, dev)


def _ones(env):
    return dataclasses.replace(env, feats=torch.ones_like(env.feats))


def _assert_cone_sums_near(got, want, rtol):
    """Covered drops the same, every sum within ``rtol`` of the drop's
    solid-angle sum."""
    assert torch.equal(got[..., 3] > 1e-9, want[..., 3] > 1e-9)
    got, want = got.double(), want.double()
    off = (got - want).abs() / want[..., 3:].clamp_min(1e-30)
    off = torch.where(want[..., 3:] > 0, off, (got - want).abs())
    print(f"largest difference: {float(off.max()):.3g} of the sa sum "
          f"(bar {rtol:.3g})")
    assert float(off.max()) <= rtol


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CONE_CASES))
def test_cone_kernel_mask_is_the_plain_mask(cuda, case):
    """With every feature 1 the four sums count the texel blocks inside
    each cone, exactly in float32 in any order: the kernel's counts equal
    the plain version's bit for bit, so no edge block flips."""
    frames, env_hw, n = CONE_CASES[case]
    p, nrm, env, cos_t = _cone_inputs(cuda, frames, env_hw, n)
    ones = _ones(env)
    before = tphot.cone_sums.launches
    got = tphot.cone_sums(p, nrm, ones, cos_t, 10.0)
    want = tphot._plain_cone_sums(p, nrm, ones, cos_t, 10.0)
    torch.cuda.synchronize()
    assert tphot.cone_sums.launches - before == 1
    assert torch.equal(got, want)
    counts = want[..., 3]
    assert float(counts.max()) > 0 and float(counts.min()) == 0
    # The drop at the origin and the one whose cone misses the map.
    assert float(counts[..., :2].max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CONE_CASES))
def test_cone_kernel_sums_match_plain(cuda, case):
    """Real features: the kernel's sums within CONE_RTOL_F64 of the plain
    mask's sums in float64 and within cone_rtol(Q) of the plain
    version's, relative to each drop's solid-angle sum."""
    frames, env_hw, n = CONE_CASES[case]
    p, nrm, env, cos_t = _cone_inputs(cuda, frames, env_hw, n, seed=1)
    got = tphot.cone_sums(p, nrm, env, cos_t, 10.0)
    want = tphot._plain_cone_sums(p, nrm, env, cos_t, 10.0)
    exact = tphot._plain_cone_sums(
        p, nrm, dataclasses.replace(env, feats=env.feats.double()), cos_t,
        10.0)
    torch.cuda.synchronize()
    print(f"{case}: the plain version against float64")
    _assert_cone_sums_near(want, exact, 1.0)
    print(f"{case}: the kernel against float64, then against plain")
    _assert_cone_sums_near(got, exact, CONE_RTOL_F64)
    _assert_cone_sums_near(got, want, cone_rtol(env.dirs.shape[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("frames,env_hw,n", [(1, (1, 1), 1),
                                             (4, (56, 149), 1),
                                             (0, (1, 257), 513),
                                             (3, (17, 31), 511),
                                             (2, (5, 103), 1025),
                                             (1, (56, 149), 2)])
def test_cone_kernel_odd_shapes(cuda, frames, env_hw, n):
    """One drop, one texel block, no frame axis, N and Q just past the
    kernel's block and tile, and a zero world position and a cone that
    misses the map (the first two drops): the covered drops and the
    counts equal the plain version's, the sums near it."""
    p, nrm, env, cos_t = _cone_inputs(cuda, frames, env_hw, n, seed=2)
    for e in (_ones(env), env):
        got = tphot.cone_sums(p, nrm, e, cos_t, 10.0)
        want = tphot._plain_cone_sums(p, nrm, e, cos_t, 10.0)
        assert got.shape == want.shape
        if e is not env:
            assert torch.equal(got, want)
        _assert_cone_sums_near(got, want, cone_rtol(env.dirs.shape[0]))
    if n > 2:
        assert float(want[..., :2, 3].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["kitti", "rig"])
def test_cone_kernel_is_deterministic_and_replays(cuda, case):
    """Two launches give the same sums bit for bit, and so does a CUDA
    graph's replay of the launch, also on inputs copied in after the
    capture."""
    frames, env_hw, n = CONE_CASES[case]
    p, nrm, env, cos_t = _cone_inputs(cuda, frames, env_hw, n, seed=3)
    q, _, env2, _ = _cone_inputs(cuda, frames, env_hw, n, seed=4)
    first = tphot.cone_sums(p, nrm, env, cos_t, 10.0)
    again = tphot.cone_sums(p, nrm, env, cos_t, 10.0)
    other = tphot.cone_sums(q, nrm, env2, cos_t, 10.0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tphot.cone_sums(p, nrm, env, cos_t, 10.0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = tphot.cone_sums(p, nrm, env, cos_t, 10.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    p.copy_(q)
    env.feats.copy_(env2.feats)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, other)


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 3100), (2, 3100, 64),
                                   (1, 3300, 3200)])
@pytest.mark.parametrize("ksize,sigma", [(15, 2.6), (25, 25.0)])
def test_blocked_blur_on_the_card_equals_the_cpu(cuda, shape, ksize, sigma):
    """The plain blur's block slabs (an axis of 3073 or more) on the
    card's tensors against the same blur on the CPU."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(4))
    taps = cv2_gaussian_kernel(ksize, sigma)
    got = separable_blur_hw(x.to(cuda), taps)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), separable_blur_hw(x, taps),
                               atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_wide_envmap_on_the_card_equals_the_cpu(cuda):
    """The full-resolution envmap of a 3840 x 2160 frame (focal 6 mm),
    (2160, 5905): its feather's W axis takes the block slabs."""
    from torch.profiler import ProfilerActivity, profile

    from raintpu_torch.ops import envmap
    from raintpu_torch.utils import profiling

    geom = envmap.envmap_geometry(2160, 3840, 6.0)
    img = torch.rand((1, 2160, 3840, 3), generator=torch.Generator()
                     .manual_seed(5))
    want = envmap.generate_envmap(img, geom)
    got = envmap.generate_envmap(img.to(cuda), geom)
    assert got.shape == (1, 2160, 5905, 3) and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    # Once its index map is on the card, the envmap copies nothing to
    # the host.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        envmap.generate_envmap(img.to(cuda), geom)
        torch.cuda.synchronize()
    summary = profiling.trace_summary(prof)
    assert summary["n_ops"] > 0
    assert not [k for k in summary["syncs"] if k.startswith("Memcpy DtoH")
                or k == "aten::_local_scalar_dense"], summary["syncs"]


def _free_address():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode,atol,launched", [("fused", 0.0, (1, 1)),
                                               ("xla", 1e-6, (0, 1))],
                         ids=["fused", "xla"])
def test_sharded_one_rank_nccl_equals_render_frames(cuda, mode, atol,
                                                    launched):
    """A one-rank nccl group's sharded render (a (1, 1) mesh: no
    collective) is render_frames: through the fused kernel bit for bit,
    in one raster and one blur launch; through the golden path within
    1e-6 (its scatter's atomics add a pixel's terms in any order), in
    one blur launch."""
    import torch.distributed as dist

    from raintpu_torch.ops.rasterize import select_textures
    from raintpu_torch.parallel import distributed
    from raintpu_torch.parallel import mesh as pmesh

    cfg, gen, drops, bg, depth, tex, edges = _scene(cuda)
    cfg = dataclasses.replace(cfg, composite_mode=mode)
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
    assert (after[0] - before[0], after[1] - before[1]) == launched
    assert want.rain_mask.sum() > 1.0
    assert torch.equal(got.overflow, want.overflow)
    for name in ("rainy_image", "rain_mask"):
        d = (getattr(got, name) - getattr(want, name)).abs().max().item()
        assert d <= atol, name


@pytest.mark.gpu
def test_sharded_two_ranks_on_the_card(cuda, tmp_path):
    """Two processes on the one card (gloo: NCCL takes one rank a GPU)
    render tests/test_sharding.py's scene. Splitting every frame's drops
    (dp 1 x sp 2): both ranks finish the same bits, within 1e-5 of
    render_frames on the card, the same alpha mass within a relative
    1e-5 and the same overflow (the planes' sums only change order).
    Splitting the frames (dp 2 x sp 1): each rank's half within 1e-6
    (only a library's choice of algorithm by batch size may move a
    value)."""
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
        half = slice(r * b // 2, (r + 1) * b // 2)
        for key, out in (("dp2_mask", want.rain_mask),
                         ("dp2_image", want.rainy_image)):
            np.testing.assert_allclose(got[key], out[half].cpu().numpy(),
                                       atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["dp2_overflow"],
                                      want.overflow[half].cpu().numpy())
    ranks = [np.load(tmp_path / f"card{r}.npz") for r in (0, 1)]
    for key in ("mask", "image", "overflow"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


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
    card against the same render on the CPU, within the render bars of
    tools/gpu_selfcheck."""
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
    _assert_near_the_cpu(got, want)


def _scene_rungs(dev):
    cfg, gen, drops, bg, depth, tex, edges = _scene(dev)
    _, env, _ = frame.frame_background(bg, depth, cfg)
    prep, _ = frame.drop_fused_params(env, drops, tex, edges, cfg,
                                      generator=gen)
    return frame.kernel_rungs(prep, cfg), cfg, tuple(tex.raw.shape[1:])


@pytest.mark.gpu
def test_ablate_empty_is_the_production_kernel(cuda):
    rungs, cfg, tex_hw = _scene_rungs(cuda)
    for sub in [[r] for r in rungs] + [rungs]:
        want = tfr.fused_raster_composite(sub, cfg.image_hw, tex_hw)
        got = tfr.fused_raster_composite(sub, cfg.image_hw, tex_hw,
                                         ablate="")
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ablate", [a for _, a, _, _ in
                                    kernel_ablation.LADDER],
                         ids=lambda a: a or "production")
def test_knockout_variant_builds_and_launches(cuda, ablate):
    """Each knockout variant of the ablation ladder builds from the
    source with its bits and launches once per call (its planes are
    garbage by design)."""
    rungs, cfg, tex_hw = _scene_rungs(cuda)
    lib = tfr.kernel_library(ablate)
    assert lib.fused_raster_ablate() == tfr.ablate_bits(ablate)
    before = tfr.fused_raster_composite.launches
    out = tfr.fused_raster_composite(rungs, cfg.image_hw, tex_hw,
                                     ablate=ablate)
    torch.cuda.synchronize()
    assert tfr.fused_raster_composite.launches - before == 1
    assert tuple(out.shape) == (B, tfr.N_PLANES, H, W)


@pytest.mark.gpu
def test_gpu_selfcheck_passes(cuda):
    assert gpu_selfcheck.main([]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fitted,dtype", [(False, "float32"),
                                          (True, "float32"),
                                          (False, "bfloat16")],
                         ids=["defaults", "FITTED=1",
                              "FIELDS_DTYPE=bfloat16"])
def test_bench_guard_launches_each_kernel_once(cuda, fitted, dtype):
    """The headline bench's guard render of workload A, at its defaults,
    with the ladder fitted to its drops and with bfloat16 planes, has no
    overflow and launches the raster kernel once and the blur kernel
    once (its JSON line is held on the CPU by tests/test_torch_bench.py)."""
    scene = bench.workload(cuda, fields_dtype=dtype)
    if fitted:
        scene = bench.fitted(scene)
    mass, launches = bench.guard(scene)
    assert launches == {"raster": 1, "blur": 1}
    assert mass > bench.MIN_MASK_MASS


def _eager_render(batch, bank, edges, cfg):
    """The eager prep, raster and finalize: (planes, FrameOutput)."""
    fogged, env_photo, env_save = frame.frame_background(
        batch["bg"], batch["depth"], cfg)
    rungs, overflow = frame.drop_fused_params(
        env_photo, batch["drops"], bank, edges, cfg,
        tex_idx=batch["tex_idx"])
    planes = tfr.fused_raster_composite(
        frame.kernel_rungs(rungs, cfg), cfg.image_hw,
        tuple(bank.raw.shape[1:]),
        tfr.N_PLANES_SAT if cfg.compute_saturation_mask else tfr.N_PLANES,
        dtype=frame.plane_dtype(cfg))
    return planes, frame.finalize_frame(
        batch["bg"], fogged, frame.crop_field_planes(planes, cfg), env_save,
        overflow, cfg)


def _graphed_render(batch, bank, edges, cfg):
    """render_frames' fused path, its prep replayed where it engages:
    (planes, FrameOutput)."""
    frame.profiling.next_step()
    fogged, env_save, planes, overflow = frame.fused_field_planes(
        batch["bg"], batch["depth"], batch["drops"], bank, edges, cfg,
        tex_idx=batch["tex_idx"])
    return planes, frame.finalize_frame(
        batch["bg"], fogged, frame.crop_field_planes(planes, cfg), env_save,
        overflow, cfg)


def _assert_renders_equal(got, want):
    (gp, go), (wp, wo) = got, want
    assert torch.equal(gp, wp)
    for name in ("rainy_image", "rain_mask", "overflow"):
        assert torch.equal(getattr(go, name), getattr(wo, name)), name


@pytest.fixture
def prep_graphs(monkeypatch):
    """A fresh PREP_GRAPHS for the test."""
    from raintpu_torch.utils import graphs

    cache = graphs.GraphCache("render.prep.replay")
    monkeypatch.setattr(frame, "PREP_GRAPHS", cache)
    return cache


def _kitti_pool(dev, batches=8, batch=8):
    """``batches`` KITTI batches (1242x375, 10 mm/hr, ``batch`` frames
    each) over one bank, edges and configuration, each batch with its
    own drops and texture picks."""
    from raintpu_torch.ops.rasterize import select_textures

    pool = []
    scene = None
    for i in range(batches):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        s = bench.workload(dev, batch=batch, generator=gen)
        scene = scene or s
        pool.append(dict(bg=s.bg * (0.5 + 0.05 * i), depth=s.depth,
                         drops=s.drops,
                         tex_idx=select_textures(s.drops, scene.edges, gen)))
    return pool, scene.bank, scene.edges, scene.cfg


def _cut_ladder(cfg):
    """``cfg`` with every rung's capacity cut to a quarter of its own, so
    that every batch overflows."""
    return dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, buckets=tuple(
            dataclasses.replace(b, capacity=max(2, b.capacity // 4))
            for b in cfg.raster.buckets)))


@pytest.mark.gpu
def test_prep_graph_replays_equal_the_eager_render(cuda, prep_graphs):
    """Two passes over an 8-batch KITTI pool, first with the hand ladder
    and then with one whose rungs overflow: the first call of each
    configuration runs eagerly, the second captures, the rest replay;
    planes, image, mask and overflow equal to the eager render's, and the
    outputs kept from the first pass unchanged by the second."""
    pool, bank, edges, cfg = _kitti_pool(cuda)
    for c in (cfg, _cut_ladder(cfg)):
        want = [_eager_render(b, bank, edges, c) for b in pool]
        kept = [_graphed_render(b, bank, edges, c) for b in pool]
        again = [_graphed_render(b, bank, edges, c) for b in pool]
        torch.cuda.synchronize()
        for k, a, w in zip(kept, again, want):
            _assert_renders_equal(k, w)
            _assert_renders_equal(a, w)
        assert float(want[0][1].rain_mask.sum()) > 1.0
    assert prep_graphs.captures == 2
    cut = [w[1].overflow for w in want]
    assert all(int(o.sum()) > 0 for o in cut)
    assert not all(torch.equal(cut[0], o) for o in cut[1:])
    # The cut ladder's two passes: eager, then a replay in every step.
    steps = frame.profiling.stage_ms("render.prep.replay", 2 * len(pool))
    assert steps[0] == 0 and all(ms > 0 for ms in steps[1:])


@pytest.mark.gpu
def test_prep_graph_replays_the_rig(cuda, prep_graphs):
    """One nuScenes rig batch (6 x 1600x900, 100 mm/hr, the whole
    population): eager, captured and replayed, then replayed again,
    equal to the eager render each time."""
    from raintpu_torch.ops.rasterize import select_textures
    from raintpu_torch.tools import stage_profile

    w = stage_profile.workload(stage_profile.parse_args(
        ["--nuscenes", "--device", "cuda"]))
    gen = torch.Generator(device=cuda).manual_seed(7)
    batch = dict(bg=w["bg"], depth=w["depth"], drops=w["drops"],
                 tex_idx=select_textures(w["drops"], w["edges"], gen))
    want = _eager_render(batch, w["tex"], w["edges"], w["cfg"])
    for _ in range(4):
        _assert_renders_equal(
            _graphed_render(batch, w["tex"], w["edges"], w["cfg"]), want)
    assert prep_graphs.captures == 1
    assert int(want[1].overflow.sum()) == 0
    assert float(want[1].rain_mask.sum()) > 1.0


@pytest.mark.gpu
def test_prep_graph_recaptures_for_a_new_config_or_bank(cuda, prep_graphs):
    """A changed PipelineConfig (the saturation planes) or texture bank
    (a copy of its tensors) is a graph of its own, equal to the eager
    render; the first graph still replays right after."""
    pool, bank, edges, cfg = _kitti_pool(cuda, batches=2)
    sat = dataclasses.replace(cfg, compute_saturation_mask=True)
    copy = bank.to("cpu").to(cuda)
    n = 0
    for bk, c in ((bank, cfg), (bank, sat), (copy, cfg), (bank, cfg)):
        for b in pool + pool:
            _assert_renders_equal(_graphed_render(b, bk, edges, c),
                                  _eager_render(b, bk, edges, c))
        n += 1
        assert prep_graphs.captures == min(n, 3)


@pytest.mark.gpu
def test_prep_graph_is_not_captured_under_a_profiler(cuda, prep_graphs):
    """Under torch.profiler the prep runs eagerly until a graph exists;
    the capture follows the profile, and a replay under a profiler is
    equal to the eager render."""
    from torch.profiler import ProfilerActivity, profile

    pool, bank, edges, cfg = _kitti_pool(cuda, batches=2)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        for b in pool + pool:
            _assert_renders_equal(_graphed_render(b, bank, edges, cfg),
                                  _eager_render(b, bank, edges, cfg))
    assert prep_graphs.captures == 0
    _graphed_render(pool[0], bank, edges, cfg)
    assert prep_graphs.captures == 1
    with profile(activities=acts) as prof:
        got = _graphed_render(pool[1], bank, edges, cfg)
        torch.cuda.synchronize()
    _assert_renders_equal(got, _eager_render(pool[1], bank, edges, cfg))
    assert prep_graphs.captures == 1
    # The replay's kernels are in the profile.
    assert sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()) > 100


@pytest.mark.gpu
def test_prep_waits_for_nothing(cuda):
    """Once its constants are made, the eager prep of a KITTI batch
    issues no synchronize and no copy to the host."""
    from torch.profiler import ProfilerActivity, profile

    from raintpu_torch.utils import profiling

    pool, bank, edges, cfg = _kitti_pool(cuda, batches=1)
    b = pool[0]
    _, env, _ = frame.frame_background(b["bg"], b["depth"], cfg)
    frame.drop_fused_params(env, b["drops"], bank, edges, cfg,
                            tex_idx=b["tex_idx"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame.drop_fused_params(env, b["drops"], bank, edges, cfg,
                                tex_idx=b["tex_idx"])
        torch.cuda.synchronize()
    syncs = profiling.trace_summary(prof)["syncs"]
    # The block's own closing synchronize aside.
    syncs.pop("cudaDeviceSynchronize", None)
    assert not syncs, syncs


@pytest.fixture
def sim_graphs(monkeypatch):
    """Fresh SIM_GRAPHS and TRUNCATION_GRAPHS for the test."""
    from raintpu_torch.physics import simulator
    from raintpu_torch.utils import graphs

    caches = {"sim.replay": graphs.GraphCache("sim.replay"),
              "sim.truncation.replay":
                  graphs.GraphCache("sim.truncation.replay")}
    monkeypatch.setattr(simulator, "SIM_GRAPHS", caches["sim.replay"])
    monkeypatch.setattr(simulator, "TRUNCATION_GRAPHS",
                        caches["sim.truncation.replay"])
    return caches


def _online_batch(dev, cfg, frames, graphed):
    """The online job's drop source for ``frames`` at 25 mm/hr over the
    KITTI ramp: the keyed simulation and the count replay, each frame on
    its own ``frame_generator``, and every generator's Philox offset
    after the calls; ``graphed`` False runs the per-frame loops
    eagerly."""
    from raintpu_torch.physics import simulator

    f = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    cols = (torch.full_like(f, 25.0), (100.0 - f % 101) / 3.6,
            torch.full_like(f, 2e-3), torch.ones_like(f))

    def gens():
        return [simulator.frame_generator(2524000101, i, dev) for i in frames]

    with pytest.MonkeyPatch.context() as m:
        if not graphed:
            m.setattr(simulator, "graph_device", lambda *a: None)
        sim_gens, count_gens = gens(), gens()
        drops = simulator.simulate_frames_keyed(sim_gens, cfg, *cols)
        counts = simulator.truncated_counts(count_gens, cfg, cols[0])
    return drops, counts, [g.get_offset() for g in sim_gens + count_gens]


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [2048, 512])
def test_sim_graph_replays_equal_the_eager_loop(cuda, sim_graphs, capacity):
    """KITTI's SimConfig at 25 mm/hr (capacity 2048, the online cell's;
    512, under the population, so that the count replay counts), 48
    frames a call: after a key's first call, three calls replay
    simulate_frames_keyed and truncated_counts, each field equal to the
    eager loop's and every generator at its offset, inside the replay
    spans; the results kept from every call unchanged by the later
    ones."""
    from raintpu_torch.data.datasets import kitti
    from raintpu_torch.physics import simulator
    from raintpu_torch.render.camera import settings_from_dict
    from raintpu_torch.utils import profiling

    cfg = simulator.SimConfig.from_settings(
        settings_from_dict(kitti.settings()), capacity=capacity)
    sets = [list(range(i * 48, (i + 1) * 48)) for i in range(4)]
    want = [_online_batch(cuda, cfg, s, graphed=False) for s in sets]

    def replays():
        return {n: sum(r[0] == n for r in profiling.RING)
                for n in sim_graphs}

    kept = []
    for i, s in enumerate(sets):
        before = replays()
        kept.append(_online_batch(cuda, cfg, s, graphed=True))
        torch.cuda.synchronize()
        after = replays()
        assert all(after[n] - before[n] == (i > 0) for n in sim_graphs)
    for (drops, counts, offsets), (w_drops, w_counts, w_offsets) in zip(
            kept, want):
        for f in dataclasses.fields(w_drops):
            assert torch.equal(getattr(drops, f.name),
                               getattr(w_drops, f.name)), f.name
        assert torch.equal(counts, w_counts)
        assert offsets == w_offsets and min(offsets) > 0
    assert all(c.captures == 1 for c in sim_graphs.values())
    assert all(int(w[0].valid.sum()) > 48 * 100 for w in want)
    cut = int(sum(w[1].sum() for w in want))
    assert (cut > 0) is (capacity < 1000), cut


def _write_customdb(root, n_frames, hw):
    """A customdb tree of ``n_frames`` frames of ``hw`` under
    ROOT/source (sequence 'drive'): .npy RGB (uint8) and depth in
    metres, no particle file. Returns ROOT/source."""
    h, w = hw
    rng = np.random.RandomState(5)
    seq = os.path.join(root, "source", "customdb", "drive")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq, sub))
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    for i in range(n_frames):
        img = np.clip(rng.rand(h, w, 3) * 0.5 + 0.4 * yy[..., None], 0, 1)
        np.save(os.path.join(seq, "rgb", f"{i:06d}.npy"),
                (img * 255).astype(np.uint8))
        np.save(os.path.join(seq, "depth", f"{i:06d}.npy"),
                (3.0 + 80.0 * (1.0 - yy) + rng.rand(h, w) * 2.0)
                .astype(np.float32))
    return os.path.join(root, "source")


# The CLI's jobs on small trees: dataset, frame (H, W), frames, batch,
# fall rate (mm/hr), the job's own arguments, the first batch's frames
# held to the CPU render, and the kernels' bar on that batch's operands
# where it is tighter than tools/gpu_selfcheck's. Every job's simulation
# capacity holds the whole population.
CLI_CASES = {
    "online": ("customdb", KITTI_HW, 4, 2, 25,
               ["--online", "--save_saturation", "--save_envmap"], 2, None),
    "offline": ("customdb", KITTI_HW, 4, 2, 25,
                ["--raster_profile", "fitted", "--save_saturation",
                 "--save_envmap"], 2, None),
    "export": ("customdb", KITTI_HW, 4, 2, 25, ["--online", "--export_xml"],
               2, None),
    "nuscenes": ("nuscenes", (900, 1600), 2, 2, 10,
                 ["--online", "--raster_profile", "fitted", "--save_envmap"],
                 1, None),
    # UHD frames: the envmap (2160, 5905) feathers its W axis on the
    # plain blur's block slabs.
    "wide": ("customdb", (2160, 3840), 2, 2, 25,
             ["--online", "--save_saturation", "--save_envmap"], 1, 5e-7),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_on_the_card_equals_the_cpu(cuda, prep_graphs, sim_graphs,
                                       tmp_path, monkeypatch, case):
    """``python -m raintpu_torch.cli`` on the card, end to end: every
    frame rendered and written with rain, nothing truncated or
    overflowed, a batch one raster launch carrying every rung and one
    blur launch; on the first batch's operands the raster and the blur
    kernel within their bars of the plain versions; the first batch's
    first frames within the render bars of the CPU render of the same
    drops and draws. offline: the simulation tool writes the particle
    XML, the native parser reads it once and caches it; export: the XML
    holds each frame's simulated drops; nuscenes: the depth tool writes
    every frame's map on the card first."""
    import glob

    from raintpu_torch import cli
    from raintpu_torch.data import db
    from raintpu_torch.ops import fog
    from raintpu_torch.particles import xml_io
    from raintpu_torch.render import online, pipeline
    from raintpu_torch.render.camera import settings_from_dict
    from raintpu_torch.tools import nuscenes_depth, stage_profile
    from torch_nuscenes_tree import write_tree

    dataset, hw, n, batch, rate, job_args, compared, atol = CLI_CASES[case]
    root = str(tmp_path)
    if dataset == "nuscenes":
        data = write_tree(os.path.join(root, "source", "nuscenes"), n, hw)
        depth_root = os.path.join(root, "depth")
        assert nuscenes_depth.process(
            data, os.path.join(depth_root, "nuscenes"), device=cuda) == n
    else:
        depth_root = _write_customdb(root, n, hw)
    settings = settings_from_dict(db.settings(dataset))
    capacity = stage_profile.full_population_capacity(settings, rate)
    out_root = os.path.join(root, "output")
    particles = os.path.join(root, "particles")
    argv = ["--dataset", dataset, "-k", os.path.join(root, "source"),
            "-d", depth_root, "--output", out_root, "-r", particles,
            "--intensity", str(rate), "--batch_size", str(batch),
            "--drop_capacity", str(capacity), "--frame_end", str(n),
            "--save_format", "npy", "--noverbose", "--device", "cuda",
            *job_args]

    calls, stats, stacks, simulated = [], {}, [], []
    render, run = pipeline.render_frames, pipeline.RenderJob.run
    blur, simulate = fog.separable_blur, online.simulate_frames_keyed

    def recorded_render(*args, **kw):
        out = render(*args, **kw)
        calls.append((args, kw, out))
        return out

    def recorded_blur(x, taps):
        stacks.append((x, taps))
        return blur(x, taps)

    def counted_simulation(*args, **kw):
        drops = simulate(*args, **kw)
        simulated.extend(drops.count().tolist())
        return drops

    monkeypatch.setattr(pipeline, "render_frames", recorded_render)
    monkeypatch.setattr(pipeline.RenderJob, "run",
                        lambda job: stats.update(run(job)) or stats)
    monkeypatch.setattr(fog, "separable_blur", recorded_blur)
    monkeypatch.setattr(online, "simulate_frames_keyed", counted_simulation)
    monkeypatch.setattr(tfr.fused_raster_composite, "carried", {})
    parses = xml_io.parse_particles_xml_raw.parses["native"]
    blur0 = blur_kernel.separable_blur.launches
    assert cli.main(argv) == 0
    torch.cuda.synchronize()

    (bg, depth, drops, bank, edges, cfg), kw, out = calls[0]
    batches = -(-n // batch)
    assert len(calls) == batches and stats["rendered"] == n
    assert stats["overflowed_drops"] == stats["truncated_drops"] == 0
    assert tfr.fused_raster_composite.carried == {
        tuple((b.ph, b.pw) for b in cfg.raster.buckets): batches}
    assert blur_kernel.separable_blur.launches - blur0 == batches
    seq, = glob.glob(os.path.join(out_root, dataset, "*"))
    rain = os.path.join(seq, "rain", f"{rate}mm")
    kinds = ["rainy_image", "rain_mask"]
    kinds += ["saturation_mask"] * cfg.compute_saturation_mask
    dirs = [os.path.join(rain, k) for k in kinds]
    dirs += [os.path.join(seq, "envmap")] * cfg.save_envmap
    for d in dirs:
        files = sorted(glob.glob(os.path.join(d, "*.npy")))
        assert len(files) == n, d
        for f in files:
            a = np.load(f)
            assert np.isfinite(a).all() and a.any(), f
            if d.endswith("envmap"):
                assert a.shape == tuple(out.envmap.shape[1:]), f
    if case == "wide":
        assert tuple(out.envmap.shape[1:]) == (2160, 5905, 3)

    _raster_matches_plain(
        _kernel_rungs((bg, depth, drops, bank, edges), cfg, kw),
        cfg.image_hw, tuple(bank.raw.shape[1:]),
        tfr.N_PLANES_SAT if cfg.compute_saturation_mask else tfr.N_PLANES,
        atol)
    x, taps = stacks[0]
    d = blur_kernel.separable_blur(x, taps) - separable_blur_hw(x, taps)
    assert d.abs().max().item() <= (atol or BLUR_ATOL)
    frames = slice(0, compared)
    _assert_near_the_cpu(out, _cpu_render((bg, depth, drops, bank, edges),
                                          cfg, kw, frames), frames)

    xml = os.path.join(particles, dataset, "drive", "rain", f"{rate}mm",
                       "0000_camera0.xml")
    if case == "offline":
        assert os.path.exists(xml) and os.path.exists(xml + ".npz")
        assert xml_io.parse_particles_xml_raw.parses["native"] == parses + 1
    if case == "export":
        streaks = xml_io.load_streaks(xml, settings.camera.wh,
                                      use_cache=False)
        assert [len(streaks[i]["ip1"]) for i in range(n)] == simulated
        assert min(simulated) > 0


@pytest.mark.gpu
def test_farm_on_the_card_renders_what_one_job_renders(cuda, tmp_path):
    """``python -m raintpu_torch.main_threaded`` on the card: two frame
    windows of a KITTI-size customdb tree rendered by two children at
    once equal one CLI job over the same frames within 1e-5 (a frame's
    drops and draws are keyed by its index, not its batch); a rerun
    skips every frame and rewrites no file."""
    import subprocess
    import sys

    from raintpu_torch import cli

    src = _write_customdb(str(tmp_path), 4, KITTI_HW)
    common = ["-k", src, "-d", src, "--online", "--device", "cuda",
              "--intensity", "25", "--batch_size", "2", "--save_format",
              "npy", "--save_saturation", "--save_envmap"]
    one, farm, logs = (str(tmp_path / d) for d in ("one", "farm", "logs"))
    os.makedirs(logs)
    assert cli.main(["--dataset", "customdb", "--frame_end", "4",
                     "--noverbose", "--output", one, *common]) == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "raintpu_torch.main_threaded",
            "--dataset", "customdb", "--frames_per_thread", "2",
            "--frame_end", "4", "--max_threads", "2", "--output", farm,
            "--log_dir", logs, *common]

    def outputs():
        return {os.path.relpath(os.path.join(d, f), farm): os.path.join(d, f)
                for d, _, files in os.walk(farm) for f in files}

    for rerun in (False, True):
        before = {k: os.stat(p).st_mtime_ns for k, p in outputs().items()}
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=300, cwd=repo)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        for tag in ("i25_s0_f0", "i25_s0_f2"):
            text = open(os.path.join(logs, f"automate_log_{tag}.txt")).read()
            want = ("'rendered': 0", "'skipped': 2") if rerun else (
                "'rendered': 2",)
            assert all(w in text for w in want), text
    assert before == {k: os.stat(p).st_mtime_ns
                      for k, p in outputs().items()}
    got = outputs()
    assert len(got) == 4 * 4
    for name, path in got.items():
        np.testing.assert_allclose(
            np.load(path).astype(np.float64),
            np.load(os.path.join(one, name)).astype(np.float64), atol=1e-5,
            rtol=0, err_msg=name)
