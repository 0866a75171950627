"""The fog stage's stencil blur (K4): the port's wrapper against the
Pallas kernel it replaces and against a float64 REFLECT_101 reference.

On the CPU ``raintpu_torch.ops.blur_kernel.separable_blur`` runs its
plain version (the band-matrix blur); the CUDA kernel itself is
held against that plain version in tests/test_torch_gpu.py. Here the
plain version meets ``separable_blur_pallas(interpret=True)`` on the
shapes of tests/test_blur_pallas.py, a float64 reference on a shape
whose radius exceeds the axis (multi-fold reflection, which the Pallas
kernel refuses), and the port's batched fog meets raintpu's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.ops.pallas.blur_kernel import separable_blur_pallas
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch.ops import blur_kernel
from raintpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur_hw
from raintpu_torch.ops.rasterize import RasterConfig
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _f64_blur(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Float64 separable blur, REFLECT_101 borders (numpy's 'reflect'
    pad folds again where the pad exceeds the axis)."""
    r = (taps.shape[0] - 1) // 2
    h, w = x.shape[-2:]
    xp = np.pad(x.astype(np.float64), ((0, 0), (r, r), (r, r)),
                mode="reflect")
    t = taps.astype(np.float64)
    rows = sum(v * xp[:, i:i + h] for i, v in enumerate(t))
    return sum(v * rows[:, :, i:i + w] for i, v in enumerate(t))


@pytest.mark.parametrize("n,h,w,ksize,sigma", [
    (3, 40, 200, 11, 3.0),
    (2, 90, 1242, 25, 25.0),
    (1, 17, 130, 15, 2.0),
    (2, 64, 120, 7, 1.5),
    (1, 375, 384, 25, 25.0),
])
def test_blur_matches_pallas_kernel(n, h, w, ksize, sigma):
    rng = np.random.RandomState(0)
    x = rng.rand(n, h, w).astype(np.float32)
    k = cv2_gaussian_kernel(ksize, sigma)
    want = np.asarray(separable_blur_pallas(jnp.asarray(x), k,
                                            interpret=True))
    got = blur_kernel.separable_blur(torch.as_tensor(x), k).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,ksize", [((2, 9, 300), 25),
                                         ((1, 3, 5), 25),
                                         ((2, 1, 40), 7)])
def test_blur_multi_fold_reflection(shape, ksize):
    rng = np.random.RandomState(1)
    x = rng.rand(*shape).astype(np.float32)
    k = cv2_gaussian_kernel(ksize, 25.0)
    got = blur_kernel.separable_blur(torch.as_tensor(x), k)
    assert torch.equal(got, separable_blur_hw(torch.as_tensor(x), k))
    np.testing.assert_allclose(got.numpy(), _f64_blur(x, k), atol=ATOL,
                               rtol=0)


def test_batched_fog_matches_raintpu():
    h, w, b = 40, 136, 2
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    jcfg = jframe.PipelineConfig.build(settings, (h, w), 25.0, 64)
    tcfg = tframe.PipelineConfig(settings=settings, image_hw=(h, w),
                                 fallrate=25.0,
                                 raster=RasterConfig.default(64))
    rng = np.random.RandomState(2)
    bg = rng.rand(b, h, w, 3).astype(np.float32)
    depth = (rng.rand(b, h, w) * 60 + 3).astype(np.float32)
    want = np.asarray(jframe.batched_fog(jnp.asarray(bg), jnp.asarray(depth),
                                         jcfg))
    got = tframe.batched_fog(torch.as_tensor(bg), torch.as_tensor(depth),
                             tcfg).numpy()
    assert got.shape == (b, h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(x=np.zeros((4, 5), np.float32)), "(N, H, W)"),
    (dict(x=np.zeros((1, 4, 5), np.float64)), "float32"),
    (dict(taps=np.ones(4, np.float32)), "odd"),
    (dict(taps=np.ones(131, np.float32)), "at most 129"),
])
def test_wrapper_checks_operands(bad, match):
    args = dict(x=np.zeros((1, 4, 5), np.float32),
                taps=cv2_gaussian_kernel(3, 1.0))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        blur_kernel.separable_blur(torch.as_tensor(args["x"]), args["taps"])
    x = torch.zeros((2, 8, 6)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        blur_kernel.separable_blur(x, cv2_gaussian_kernel(3, 1.0))
