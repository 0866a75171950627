"""Per-pixel and per-drop stages of the port against raintpu on the CPU.

Inputs come from numpy seeds and go through the JAX function and its
port. Per-pixel stages agree to atol 1e-5: both sides compute in
float32 and differ only in the order of float sums and in the last bits
of transcendentals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.ops import blur as jblur
from raintpu.ops import color as jcolor
from raintpu.ops import composite as jcomp
from raintpu.ops import envmap as jenv
from raintpu.ops import fog as jfog
from raintpu.ops import photometry as jphot
from raintpu.ops import solid_angle as jsa
from raintpu.physics import dsd as jdsd
from raintpu.physics import simulator as jsim
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch.ops import blur as tblur
from raintpu_torch.ops import color as tcolor
from raintpu_torch.ops import composite as tcomp
from raintpu_torch.ops import envmap as tenv
from raintpu_torch.ops import fog as tfog
from raintpu_torch.ops import photometry as tphot
from raintpu_torch.ops import solid_angle as tsa
from raintpu_torch.physics import dsd as tdsd
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def close(t, j, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=rtol)


def test_color_roundtrip_and_basis(rng):
    rgb = rng.rand(64, 3).astype(np.float32)
    rgb[0] = 0.0                                  # black: x, y -> 0
    close(tcolor.rgb_to_xyY(torch.as_tensor(rgb)),
          jcolor.rgb_to_xyY(jnp.asarray(rgb)))
    xyY = np.array(jcolor.rgb_to_xyY(jnp.asarray(rgb[1:])))
    close(tcolor.xyY_to_rgb(torch.as_tensor(xyY)),
          jcolor.xyY_to_rgb(jnp.asarray(xyY)))
    x, y = rng.uniform(0.2, 0.4, (2, 16)).astype(np.float32)
    close(tcolor.xyY_basis_rgb(torch.as_tensor(x), torch.as_tensor(y)),
          jcolor.xyY_basis_rgb(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("hw", [(12, 30), (23, 117)])
def test_solid_angle_and_directions(hw):
    close(tsa.solid_angle_map(*hw), jsa.solid_angle_map(*hw))
    close(tsa.pixel_directions(*hw), jsa.pixel_directions(*hw))


@pytest.mark.parametrize("shape,ksize,sigma", [
    ((2, 30, 50), 25, 25.0),      # the fog kernel, radius < axis
    ((3, 7, 9), 15, 2.6),         # feather kernel, r >= n: multi-fold
    ((1, 5, 1), 25, 25.0),        # degenerate n == 1 axis
])
def test_separable_blur(rng, shape, ksize, sigma):
    x = rng.rand(*shape).astype(np.float32)
    k = jblur.cv2_gaussian_kernel(ksize, sigma)
    np.testing.assert_array_equal(tblur.cv2_gaussian_kernel(ksize, sigma), k)
    close(tblur.separable_blur_hw(torch.as_tensor(x), k),
          jblur.separable_blur_hw(jnp.asarray(x), k))
    img = np.moveaxis(x, 0, -1)
    close(tblur.separable_blur(torch.as_tensor(img), k),
          jblur.separable_blur(jnp.asarray(img), k))


@pytest.mark.parametrize("shape", [
    (1, 4, 3073),     # the threshold itself; r >= H stays dense
    (2, 12, 3100),    # a wide W, the tail block cropped
    (2, 3100, 12),    # a tall H
])
@pytest.mark.parametrize("ksize,sigma", [(15, 2.6), (25, 25.0)])
def test_blur_refuses_wide_axes(rng, shape, ksize, sigma):
    """The dense product refuses axes of _BLOCKED_BLUR_MIN_DIM or more:
    they take raintpu's block slabs, and the blur still matches it."""
    assert max(shape) >= tblur._BLOCKED_BLUR_MIN_DIM
    x = rng.rand(*shape).astype(np.float32)
    k = jblur.cv2_gaussian_kernel(ksize, sigma)
    close(tblur.separable_blur_hw(torch.as_tensor(x), k),
          jblur.separable_blur_hw(jnp.asarray(x), k))


def test_fog_rain_layer(rng):
    img = rng.rand(2, 24, 40, 3).astype(np.float32)
    depth = (rng.rand(2, 24, 40) * 60 + 3).astype(np.float32)
    kw = dict(rain_intensity=25.0, f_number=6.0, exposure_s=2e-3,
              camera_gain=20.0)
    assert tfog.beta_ext(25.0) == jfog.beta_ext(25.0)
    assert tfog.beta_hg(90.0) == jfog.beta_hg(90.0)
    close(tfog.fog_rain_layer(torch.as_tensor(img), torch.as_tensor(depth),
                              **kw),
          jfog.fog_rain_layer(jnp.asarray(img), jnp.asarray(depth), **kw))


@pytest.mark.parametrize("hw", [(12, 24), (23, 77), (48, 96)])
def test_generate_envmap(rng, hw):
    geom = jenv.envmap_geometry(*hw, 6.0)
    assert dataclasses.asdict(tenv.envmap_geometry(*hw, 6.0)) == \
        dataclasses.asdict(geom)
    jr, jc, jcov = jenv._source_indices(geom)
    tr, tc, tcov = tenv._source_indices(geom)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tcov.numpy(), np.asarray(jcov))
    bg = rng.rand(2, *hw, 3).astype(np.float32)
    got = tenv.generate_envmap(torch.as_tensor(bg), geom)
    for b in range(2):
        close(got[b], jenv.generate_envmap(jnp.asarray(bg[b]), geom))


@pytest.mark.parametrize("ds", [1, 4])
def test_avg_pool_rgb(rng, ds):
    img = rng.rand(2, 27, 38, 3).astype(np.float32)
    close(tframe._avg_pool_rgb(torch.as_tensor(img), ds),
          jframe._avg_pool_rgb(jnp.asarray(img), ds))


def _drops_mid(rng, n):
    """Mid-streak world positions in the parsed frame, a few degenerate."""
    p = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 3, n),
                  rng.uniform(0.3, 20, n)], -1).astype(np.float32)
    p[0] = 0.0
    return p


@pytest.mark.parametrize("downsample", [1, 2])
def test_photometry(rng, downsample, monkeypatch):
    env = rng.rand(2, 12, 40, 3).astype(np.float32)
    mid = np.stack([_drops_mid(rng, 48) for _ in range(2)])
    t_env = torch.as_tensor(env)
    t_feat = tphot.env_features(t_env, downsample=downsample)
    for b in range(2):
        j_feat = jphot.env_features(jnp.asarray(env[b]),
                                    downsample=downsample)
        close(t_feat.feats[b], j_feat.feats)
        close(t_feat.dirs, j_feat.dirs)
        close(t_feat.total_sa, j_feat.total_sa)
        close(t_feat.ambient_lum[b], j_feat.ambient_lum)
    got = tphot.drop_colors(torch.as_tensor(mid), t_feat)
    want = [jphot.drop_colors(jnp.asarray(mid[b]), jphot.env_features(
        jnp.asarray(env[b]), downsample=downsample)) for b in range(2)]
    close(got, np.stack(want))
    # The drop-axis chunking gives the same sums.
    monkeypatch.setattr(tphot, "MAX_MASK_ELEMS", 1)
    monkeypatch.setattr(tphot, "_FOV_CHUNK", 16)
    close(tphot.drop_colors(torch.as_tensor(mid), t_feat), got, atol=1e-6)


def test_cone_sums_on_the_cpu_are_the_plain_sums(rng, monkeypatch):
    """On CPU tensors drop_fov_stats runs the plain cone sums, never the
    kernel; chunked over the drop axis they agree with one chunk."""
    env = tphot.env_features(
        torch.as_tensor(rng.rand(2, 12, 40, 3).astype(np.float32)),
        downsample=2)
    p = tphot.swap_yz(torch.as_tensor(
        np.stack([_drops_mid(rng, 40) for _ in range(2)])))
    n = p / torch.clamp_min(torch.sqrt((p * p).sum(-1, keepdim=True)),
                            1e-12)
    cos_t = tphot._cos_half_angle(82.5, torch.float32, p.device)

    def refuse(*args):
        raise AssertionError("the kernel's path on CPU tensors")

    monkeypatch.setattr(tphot, "_kernel_cone_sums", refuse)
    launches = tphot.cone_sums.launches
    want = tphot._cone_sums(p, n, env, cos_t, 10.0)
    assert torch.equal(tphot.cone_sums(p, n, env, cos_t, 10.0), want)
    stats = tphot.drop_fov_stats(tphot.swap_yz(p), env, fov_deg=165.0)
    monkeypatch.setattr(tphot, "MAX_MASK_ELEMS", 1)
    monkeypatch.setattr(tphot, "_FOV_CHUNK", 16)
    close(tphot.cone_sums(p, n, env, cos_t, 10.0), want, atol=1e-6)
    for got, w in zip(tphot.drop_fov_stats(tphot.swap_yz(p), env,
                                           fov_deg=165.0), stats):
        close(got, w, atol=1e-6)
    assert tphot.cone_sums.launches == launches
    assert float(want[..., 3].min()) == 0.0 < float(want[..., 3].max())


def test_dsd(rng):
    d = rng.uniform(0.05, 5.0, 64).astype(np.float32)
    u = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    for rate in (0.5, 10.0, 100.0):
        close(tdsd.mp_lambda(rate), jdsd.mp_lambda(rate), rtol=1e-6)
        close(tdsd.concentration_above(torch.as_tensor(d), rate),
              jdsd.concentration_above(jnp.asarray(d), rate), rtol=1e-5)
        close(tdsd.sample_diameter_above(torch.as_tensor(u),
                                         torch.as_tensor(d), rate),
              jdsd.sample_diameter_above(jnp.asarray(u), jnp.asarray(d),
                                         rate), rtol=1e-5)
    close(tdsd.terminal_velocity(torch.as_tensor(d)),
          jdsd.terminal_velocity(jnp.asarray(d)))


@pytest.mark.parametrize("fallrate", [1.0, 10.0, 50.0])
def test_expected_drop_count(fallrate):
    st = RenderSettings(camera=CameraSettings())
    j = jsim.SimConfig.from_settings(st, capacity=512)
    t = tsim.SimConfig.from_settings(st, capacity=512)
    want = jsim.expected_drop_count(j, fallrate)
    assert abs(tsim.expected_drop_count(t, fallrate) - want) <= 1e-5 * want
    jr, jz = jsim._strata_rates(j, fallrate)
    tr, tz = tsim._strata_rates(t, fallrate)
    close(tz, jz)
    # Deep strata underflow to denormals; compare against the peak rate.
    close(tr, jr, atol=1e-6 * float(np.max(jr)), rtol=1e-5)



@pytest.mark.parametrize("strategy", [None, "white", "naive_db"])
def test_blend_coefficients_and_blend(rng, strategy):
    iw1, iw2 = rng.uniform(0.5, 6, (2, 40)).astype(np.float32)
    length = rng.randint(1, 80, 40).astype(np.int32)
    kw = dict(exposure_s=2e-3, opacity_attenuation=0.8,
              rendering_strategy=strategy)
    t_lo, t_add = tcomp.blend_coefficients(
        torch.as_tensor(iw1), torch.as_tensor(iw2), torch.as_tensor(length),
        **kw)
    j_lo, j_add = jcomp.blend_coefficients(
        jnp.asarray(iw1), jnp.asarray(iw2), jnp.asarray(length), **kw)
    close(t_lo, j_lo)
    close(t_add, j_add, rtol=1e-6)
    fogged = rng.rand(2, 8, 12, 3).astype(np.float32)
    log_att = -rng.rand(2, 8, 12).astype(np.float32)
    add = rng.rand(2, 8, 12, 3).astype(np.float32) * 0.3
    alpha = rng.rand(2, 8, 12).astype(np.float32)
    got = tcomp.blend(torch.as_tensor(fogged), tcomp.FieldMaps(
        log_att=torch.as_tensor(log_att), additive=torch.as_tensor(add),
        alpha=torch.as_tensor(alpha)))
    want = jcomp.blend(jnp.asarray(fogged), jcomp.FieldMaps(
        log_att=jnp.asarray(log_att), additive=jnp.asarray(add),
        alpha=jnp.asarray(alpha)))
    close(got, want)
