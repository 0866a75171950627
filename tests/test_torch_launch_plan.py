"""Launch plans of the port's two CUDA kernels, checked on the CPU.

The raster kernel (K1/K2) cuts each drop's window into row chunks of
about ``fused_raster.TARGET_PX`` pixels, one block each; the blur kernel
(K4) takes tiles whose halo must fit the block's shared memory. Both
plans are plain Python (``raster_plan``, ``blur_plan``) whose results
the wrappers pass to the C entry points, so their geometry is held here:
chunks cover every window row once, small windows stay one block, grids
stay inside CUDA's limits at the CLI's capacities, and every radius the
blur takes fits 227 KB of shared memory.
"""

import pytest

from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.ops.rasterize import RasterConfig

# bench.py's hand ladder (ph, pw, capacity) and the CLI's default ladder
# at its --drop_capacity default.
HAND = ((24, 32, 224), (48, 32, 64), (96, 64, 32), (112, 96, 16))
CLI_CAPACITY = 2048
DEFAULT = tuple((b.ph, b.pw, b.capacity)
                for b in RasterConfig.default(CLI_CAPACITY).buckets)
WINDOWS = sorted({(ph, pw) for ph, pw, _ in HAND + DEFAULT}
                 | {(5, 7), (1, 1), (4096, 1), (1, 5000), (331, 13)})
# The fog stacks of the two paths: 4 planes a frame, batch 8 (CLI) and
# batch 48 (bench), at KITTI size.
FOG = ((32, 375, 1242), (192, 375, 1242))


@pytest.mark.parametrize("patch_hw", WINDOWS)
def test_chunks_cover_every_window_row_once(patch_hw):
    ph, pw = patch_hw
    plan = tfr.raster_plan(patch_hw, slots=3, frames=2)
    rows = [i for k in range(plan.n_chunks)
            for i in range(k * plan.rows, min((k + 1) * plan.rows, ph))]
    assert rows == list(range(ph))
    # Every chunk holds at least one row (the kernel's plan check).
    assert (plan.n_chunks - 1) * plan.rows < ph <= plan.n_chunks * plan.rows
    # About TARGET_PX pixels a chunk, never fewer than one row.
    assert plan.rows == 1 or plan.rows * pw <= tfr.TARGET_PX
    assert plan.rows * pw > tfr.TARGET_PX - pw or plan.rows == ph
    assert plan.grid == (3 * plan.n_chunks, 2)


@pytest.mark.parametrize("patch_hw", [(24, 32), (48, 32), (40, 32), (32, 64),
                                      (1, tfr.TARGET_PX), (48, 42)])
def test_window_at_or_under_target_is_one_block(patch_hw):
    assert patch_hw[0] * patch_hw[1] <= tfr.TARGET_PX
    plan = tfr.raster_plan(patch_hw, slots=5, frames=4)
    assert (plan.rows, plan.n_chunks) == (patch_hw[0], 1)
    assert plan.grid == (5, 4)


def test_big_windows_spread_over_many_blocks():
    # The default ladder's multi-tile rungs at TARGET_PX = 2048: 5 and 10
    # rows a chunk.
    assert tfr.TARGET_PX == 2048
    assert tfr.raster_plan((704, 384), 64, 8).n_chunks == -(-704 // 5)
    assert tfr.raster_plan((320, 192), 256, 8).n_chunks == 32


@pytest.mark.parametrize("ladder,frames", [(HAND, 48), (DEFAULT, 8),
                                           (DEFAULT, 64)])
def test_grid_within_cuda_limits(ladder, frames):
    for ph, pw, cap in ladder:
        gx, gy = tfr.raster_plan((ph, pw), cap, frames).grid
        assert 0 < gx <= tfr.MAX_GRID_X and 0 < gy <= tfr.MAX_GRID_Y


def test_plan_refuses_grids_beyond_cuda_limits():
    with pytest.raises(ValueError, match="limits"):
        tfr.raster_plan((40, 32), 8, tfr.MAX_GRID_Y + 1)
    with pytest.raises(ValueError, match="limits"):
        tfr.raster_plan((704, 384), 2 ** 26, 1)


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


def test_blur_plan_refuses_more_tiles_than_the_kernel_numbers():
    with pytest.raises(ValueError, match="limit"):
        blur_kernel.blur_plan(blur_kernel.MAX_PLANES, 2 ** 20, 2048, 1)
