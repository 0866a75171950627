"""Launch plans of the port's CUDA kernels, checked on the CPU.

The raster kernel (K1/K2/K3) takes every rung in one launch, one block
per (image tile, frame), each block listing the drops whose windows
overlap its tile; the blur kernel (K4) takes tiles whose halo must fit
the block's shared memory. Both plans are plain Python (``tile_plan``,
``blur_plan``) whose results the wrappers pass to the C entry points,
which re-check them, so their geometry is held here: the tiles cover
the image once, grids stay inside CUDA's limits, shared memory fits
every ladder's series, a launch takes at most ``MAX_RUNGS`` rungs, the
tile lists (``_tile_drops``, a plain mirror of the kernel's binning)
agree with a pixel-by-pixel enumeration, and every radius the blur takes
fits 227 KB of shared memory. The cone sums' plan (``cone_plan``) covers
every drop and texel block once and fills the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.ops import photometry as tphot
from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig

# bench.py's hand ladder (ph, pw, capacity) and the CLI's default ladder
# at its --drop_capacity default.
HAND = ((24, 32, 224), (48, 32, 64), (96, 64, 32), (112, 96, 16))
CLI_CAPACITY = 2048
DEFAULT = tuple((b.ph, b.pw, b.capacity)
                for b in RasterConfig.default(CLI_CAPACITY).buckets)
# A fitted ladder's shape (ops.rasterize.fit_raster_config): widths
# snapped to 64 - 2 * pad or 128 - 2 * pad (pad = int(1.25 * radius) +
# 2), series (12, 6, 3), (24, 10, 4), (16, 8, 4), ranks 3 and 4 in one
# launch, and a tail rung over the sampled max times 1.15, taller than
# any default rung.
FITTED_SPECS = (BucketSpec(24, 50, 4, 88, 12, 6, 3),
                BucketSpec(40, 40, 8, 32, 12, 6, 3),
                BucketSpec(56, 114, 4, 24, 24, 10, 4),
                BucketSpec(776, 256, 40, 16, 16, 8, 4))
FITTED = tuple((b.ph, b.pw, b.capacity) for b in FITTED_SPECS)
WINDOWS = sorted({(ph, pw) for ph, pw, _ in HAND + DEFAULT + FITTED}
                 | {(5, 7), (1, 1), (4096, 1), (1, 5000), (331, 13)})
# The fog stacks of the two paths: 4 planes a frame, batch 8 (CLI) and
# batch 48 (bench), at KITTI size.
FOG = ((32, 375, 1242), (192, 375, 1242))


# Image shapes for the tiles' coverage: KITTI, the card tests' shapes
# and odd ones (narrower or shorter than a tile, one pixel wide or tall).
IMAGES = ((375, 1242), (400, 1242), (160, 320), (160, 120), (48, 96),
          (1, 1), (17, 1000), (4096, 1), (1, 5000), (331, 13))
# The texture bank's full series (rank 6, 32 x 12 modes), which a
# ladder's zero modes_y / modes_x / ranks keep.
BANK_SERIES = (6, 32, 12)


def _series(ladder):
    """(R, My, Mx) of each rung of a ladder of BucketSpecs."""
    r0, my0, mx0 = BANK_SERIES
    return [(b.ranks or r0, b.modes_y or my0, b.modes_x or mx0)
            for b in ladder]


HAND_SPECS = (BucketSpec(24, 32, 5, 224, 12, 6, 3),
              BucketSpec(48, 32, 8, 64, 12, 6, 3),
              BucketSpec(96, 64, 12, 32, 24, 10, 4),
              BucketSpec(112, 96, 20, 16, 16, 8, 4))
LADDERS = {"hand": HAND_SPECS,
           "default": RasterConfig.default(CLI_CAPACITY).buckets,
           "fitted": FITTED_SPECS}


def _tile_rect(plan, image_hw, tile):
    h, w = image_hw
    th, tw = plan.tile_hw
    tiles_x = -(-w // tw)
    y0, x0 = (tile // tiles_x) * th, (tile % tiles_x) * tw
    return y0, min(y0 + th, h), x0, min(x0 + tw, w)


@pytest.mark.parametrize("image_hw", IMAGES)
def test_tiles_cover_the_image_once(image_hw):
    plan = tfr.tile_plan(image_hw, [(3, 12, 6)], frames=2, n_planes=5)
    count = np.zeros(image_hw, np.int32)
    for tile in range(plan.grid[0]):
        y0, y1, x0, x1 = _tile_rect(plan, image_hw, tile)
        assert y0 < y1 and x0 < x1, "every tile holds a pixel"
        count[y0:y1, x0:x1] += 1
    assert (count == 1).all()
    assert plan.grid[1] == 2


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("frames", [8, 48, 64])
def test_grid_within_cuda_limits(ladder, frames):
    for image_hw in ((375, 1242), (4096, 1), (1, 5000)):
        gx, gy = tfr.tile_plan(image_hw, _series(LADDERS[ladder]), frames,
                               8).grid
        assert 0 < gx <= tfr.MAX_GRID_X and gy == frames <= tfr.MAX_GRID_Y


def test_plan_refuses_grids_beyond_cuda_limits():
    with pytest.raises(ValueError, match="limits"):
        tfr.tile_plan((375, 1242), [(3, 12, 6)], tfr.MAX_GRID_Y + 1, 5)


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("n_planes", [5, 8])
def test_smem_fits_every_ladder(ladder, n_planes):
    series = _series(LADDERS[ladder])
    plan = tfr.tile_plan((375, 1242), series, 48, n_planes)
    coef = max(r * (my + mx) for r, my, mx in series)
    assert plan.coef_floats == coef and plan.n_rungs == len(series)
    assert plan.list_cap == tfr.LIST_CAP >= tfr.THREADS
    assert plan.smem_bytes == tfr.raster_smem_bytes(n_planes, plan.tile_hw,
                                                    coef)
    # Two blocks fit an SM's 228 KB, whatever the ladder.
    assert 2 * plan.smem_bytes <= tfr.MAX_SMEM_BYTES
    # The bank's whole series fits as well.
    full = tfr.tile_plan((375, 1242), [BANK_SERIES], 48, n_planes)
    assert full.smem_bytes <= tfr.MAX_SMEM_BYTES


@pytest.mark.parametrize("n_rungs", [0, tfr.MAX_RUNGS + 1])
def test_plan_and_wrapper_refuse_rung_counts(n_rungs):
    with pytest.raises(ValueError, match="rungs"):
        tfr.tile_plan((375, 1242), [(3, 12, 6)] * n_rungs, 8, 5)
    rung = _rung([(24, 32)], [[[0, 0]]], [1])[0]
    with pytest.raises(ValueError, match="rungs"):
        tfr.fused_raster_composite([rung] * n_rungs, (40, 60), (64, 32))


def test_wrapper_refuses_rungs_that_disagree():
    a, b = _rung([(24, 32), (24, 32)], [[[0, 0]], [[5, 5]]], [1, 1])
    two = dataclasses.replace(b, **{k: getattr(b, k).expand(
        2, *getattr(b, k).shape[1:]).contiguous()
        for k in ("params", "anchor", "ayc", "bxc", "n_valid")})
    with pytest.raises(ValueError, match="batch size"):
        tfr.fused_raster_composite([a, two], (40, 60), (64, 32))
    meta = dataclasses.replace(b, n_valid=b.n_valid.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tfr.fused_raster_composite([a, meta], (40, 60), (64, 32))


def _rung(windows, anchors, n_valid):
    """One frame's rungs with the given windows, anchors and valid
    counts (params and series zero: only the geometry matters here)."""
    out = []
    for (ph, pw), anchor, n in zip(windows, anchors, n_valid):
        c = len(anchor)
        out.append(tfr.RasterRung(
            params=torch.zeros((1, tfr.N_PARAMS, c)),
            anchor=torch.tensor([anchor], dtype=torch.int32),
            ayc=torch.zeros((1, c, 1, 2)), bxc=torch.zeros((1, c, 1, 2)),
            n_valid=torch.tensor([n], dtype=torch.int32), patch_hw=(ph, pw)))
    return out


def _edge_anchors(patch_hw, image_hw):
    """Window origins on and past every edge of the image (anchors are
    clipped to [0, W] x [0, H]) and inside it."""
    (ph, pw), (h, w) = patch_hw, image_hw
    xs = sorted({0, 1, max(0, w - pw), max(0, w - pw + 1), w - 1, w,
                 w // 2})
    ys = sorted({0, 1, max(0, h - ph), max(0, h - ph + 1), h - 1, h,
                 h // 2})
    return [(x, y) for y in ys for x in xs]


def _tile_drops(windows, anchors, n_valid, image_hw, tile_hw, tile):
    """The drops of one frame whose windows overlap image tile ``tile``
    (row-major over ``tile_hw`` tiles), as the kernel's block lists
    them: (rung, slot) in rung-major, slot-minor order. ``windows`` is
    each rung's (ph, pw), ``anchors`` each rung's (C, 2) window origins
    (x, y), ``n_valid`` each rung's valid slot count. A plain Python
    mirror of the kernel's overlap test and scan order."""
    h, w = image_hw
    th, tw = tile_hw
    tiles_x = -(-w // tw)
    tx0, ty0 = (tile % tiles_x) * tw, (tile // tiles_x) * th
    tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)
    out = []
    for r, ((ph, pw), anchor, n) in enumerate(zip(windows, anchors,
                                                  n_valid)):
        for c in range(min(int(n), len(anchor))):
            ax, ay = (int(v) for v in anchor[c])
            if (max(ax, tx0) < min(ax + pw, tx1)
                    and max(ay, ty0) < min(ay + ph, ty1)):
                out.append((r, c))
    return out


@pytest.mark.parametrize("patch_hw", WINDOWS)
def test_tile_lists_match_pixel_enumeration(patch_hw):
    """Every in-image pixel of every valid window lands in exactly one
    tile, and that tile lists the drop; a tile lists only drops with a
    pixel in it, in rung-major, slot-minor order."""
    image_hw = (375, 1242)
    h, w = image_hw
    anchors = _edge_anchors(patch_hw, image_hw)
    # A second rung of small windows between the first rung's slots,
    # and invalid slots past n_valid in both.
    windows = [patch_hw, (24, 32)]
    rung_anchors = [anchors + [(0, 0)] * 3,
                    [(x, y) for x, y in anchors[::3]] + [(600, 200)] * 2]
    n_valid = [len(anchors), len(rung_anchors[1]) - 2]
    plan = tfr.tile_plan(image_hw, [(1, 2, 2)] * 2, 1, 5)
    th, tw = plan.tile_hw
    tiles_x = -(-w // tw)
    want = {}
    for r, ((ph, pw), anchor, n) in enumerate(zip(windows, rung_anchors,
                                                  n_valid)):
        for c, (ax, ay) in enumerate(anchor[:n]):
            ys, xs = np.mgrid[ay:min(ay + ph, h), ax:min(ax + pw, w)]
            for tile in np.unique((ys // th) * tiles_x + xs // tw):
                want.setdefault(int(tile), []).append((r, c))
    for tile in range(plan.grid[0]):
        got = _tile_drops(windows, rung_anchors, n_valid, image_hw,
                          plan.tile_hw, tile)
        assert got == sorted(got)
        assert got == want.get(tile, [])


@pytest.mark.parametrize("ksize", range(1, blur_kernel.MAX_TAPS + 1, 2))
def test_blur_smem_fits_every_radius(ksize):
    radius = (ksize - 1) // 2
    for n, h, w in FOG + ((1, 3100, 40), (2, 9, 300)):
        plan = blur_kernel.blur_plan(n, h, w, radius)
        assert plan.smem_bytes <= blur_kernel.MAX_SMEM_BYTES == 232448
        assert plan.smem_bytes == blur_kernel.blur_smem_bytes(
            radius, plan.tile_h, plan.tile_w)
        assert plan.tile_h % blur_kernel.RUN == 0
        assert plan.tile_w % blur_kernel.RUN == 0


@pytest.mark.parametrize("shape", FOG + ((2, 37, 333), (1, 17, 130),
                                         (3, 40, 200), (1, 40, 3100),
                                         (2, 1, 40), (1, 3, 5)))
@pytest.mark.parametrize("ksize", [11, 25, 129])
def test_blur_tiles_cover_the_plane(shape, ksize):
    n, h, w = shape
    plan = blur_kernel.blur_plan(n, h, w, (ksize - 1) // 2)
    gx, gy, gz = plan.tiles
    assert gz == n
    assert (gx - 1) * plan.tile_w < w <= gx * plan.tile_w
    assert (gy - 1) * plan.tile_h < h <= gy * plan.tile_h


def test_blur_plan_of_the_fog_stack():
    # The fog's 25 taps take the full tile: 12 x 10 tiles a KITTI plane.
    plan = blur_kernel.blur_plan(32, 375, 1242, 12)
    assert (plan.tile_h, plan.tile_w) == blur_kernel.TILE_HW == (32, 128)
    assert plan.tiles == (10, 12, 32)
    # (25 taps + 2 halo tiles of 56 x 152 + the 152 x 33 intermediate +
    # the 32 x 129 staging tile) floats: two blocks fit an SM.
    assert plan.smem_bytes == 4 * (25 + 2 * 56 * 152 + 152 * 33 + 32 * 129)
    assert 2 * plan.smem_bytes <= blur_kernel.MAX_SMEM_BYTES


@pytest.mark.parametrize("n,ksize", [(24, 25), (1, 7)])
def test_blur_plan_of_the_nuscenes_shapes(n, ksize):
    """The fog stack of the 6-frame 1600 x 900 rig and the depth
    smoothing's 7-tap Gaussian take the full tile: 13 x 29 tiles a
    plane, two blocks an SM."""
    radius = (ksize - 1) // 2
    plan = blur_kernel.blur_plan(n, 900, 1600, radius)
    assert (plan.tile_h, plan.tile_w) == blur_kernel.TILE_HW
    assert plan.tiles == (13, 29, n)
    assert plan.smem_bytes == 4 * (ksize + 2 * (32 + 2 * radius)
                                   * (128 + 2 * radius)
                                   + (128 + 2 * radius) * 33 + 32 * 129)
    assert 2 * plan.smem_bytes <= blur_kernel.MAX_SMEM_BYTES


def test_blur_plan_refuses_more_tiles_than_the_kernel_numbers():
    with pytest.raises(ValueError, match="limit"):
        blur_kernel.blur_plan(blur_kernel.MAX_PLANES, 2 ** 20, 2048, 1)


# The cone sums' (frames, N, Q): KITTI at 10 and 200 mm/hr, the nuScenes
# rig, Cityscapes (cone_downsample 4), KITTI at cone_downsample 1, and
# odd ones (one drop or texel block, a frame count at the grid's limit,
# a block and a tile and one more).
CONE_SHAPES = ((48, 320, 2691), (48, 3200, 2691), (6, 16000, 8344),
               (48, 768, 3007), (48, 320, 44361), (1, 1, 1), (1, 1, 300),
               (tphot.MAX_GRID_YZ, 1, 5), (3, 513, 257))
H100_SMS = 132


@pytest.mark.parametrize("frames,n,q", CONE_SHAPES)
def test_cone_plan_covers_drops_and_texels_once(frames, n, q):
    plan = tphot.cone_plan(frames, n, q, H100_SMS)
    per = tphot.DROPS_PER_BLOCK
    assert (plan.drop_blocks - 1) * per < n <= plan.drop_blocks * per
    assert (plan.splits - 1) * plan.q_per_split < q
    assert q <= plan.splits * plan.q_per_split
    assert 1 <= plan.splits <= min(tphot.MAX_GRID_YZ,
                                   -(-q // tphot.CONE_TILE))
    # Enough blocks to fill the card, unless every tile is a part.
    blocks = frames * plan.drop_blocks * plan.splits
    assert (blocks >= tphot.BLOCKS_PER_SM * H100_SMS
            or plan.splits == -(-q // tphot.CONE_TILE))
    # As few parts as that takes.
    if plan.splits > 1:
        fewer = frames * plan.drop_blocks * (plan.splits - 1)
        assert fewer < tphot.BLOCKS_PER_SM * H100_SMS


def test_cone_plan_splits_only_where_drops_are_few():
    """The rig's 96,000 drop slots and KITTI's 15,360 both split; a
    batch whose drops alone fill the card does not."""
    assert tphot.cone_plan(6, 16000, 8344, H100_SMS).splits == 11
    assert tphot.cone_plan(48, 320, 2691, H100_SMS).splits == 11
    assert tphot.cone_plan(48, 3200, 2691, H100_SMS).splits == 7
    assert tphot.cone_plan(48, 24000, 2691, H100_SMS).splits == 1


@pytest.mark.parametrize("a,b", [((48,), ()), ((), (6,)), ((6,), (6,)),
                                 ((2, 3), (3,)), ((1,), (5,)), ((0,), (1,)),
                                 ((4, 1), (1, 7)), ((), ())])
def test_cone_lead_shape_is_the_broadcast(a, b):
    """The kernel wrapper's leading shape of drops and features is
    torch's broadcast of the two."""
    assert tphot._broadcast(a, b) == tuple(torch.broadcast_shapes(a, b))
