"""The port's fitted bucket ladder against raintpu's.

On the same batched drop sample both packages compute every drop's
needed window (nw, nh) and 4 sigma — held within 1e-5 first, so that a
ladder that differs can be traced to a drop — and then fit a
RasterConfig equal field for field: the physics strategy, 'white' (no
defocus) and streak noise (needs over noise 0 and +-3 std). An empty
population falls back to the same ladder."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raintpu.ops import rasterize as jrz
from raintpu.physics.simulator import SimConfig, simulate_frames
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.ops import rasterize as trz
from torch_cpu_threads import one_torch_thread  # noqa: F401

W, H, B, CAP = 310, 94, 4, 256
TEX_HW = (64, 32)
CASES = {"physics": {}, "white": {"rendering_strategy": "white"},
         "noise": {"noise_scale": 1.0, "noise_std": 4.0}}


def _sample(case):
    settings = dataclasses.replace(
        RenderSettings(camera=CameraSettings(wh=(W, H), ccd_wh=(W, H))),
        **CASES[case])
    sim = SimConfig.from_settings(settings, capacity=CAP)
    drops = simulate_frames(
        jax.random.PRNGKey(0), sim, jnp.full(B, 50.0), jnp.full(B, 8.0),
        jnp.full(B, settings.camera.exposure_s), jnp.ones(B))
    return settings, drops


def _jax_needs(drops, settings):
    """raintpu's fit_raster_config needs, written out (they are a local
    function there)."""
    cam = settings.camera
    noise_max = 3.0 * settings.noise_std * settings.noise_scale

    def one(d, nz):
        g = jrz.drop_geometry(
            d, TEX_HW, (W, H), focal_m=cam.focal_m, f_number=cam.f_number,
            focus_plane=settings.focus_plane, coc_pixsize=4.65e-6,
            apply_defocus=settings.rendering_strategy is None,
            noise_deg=jnp.full((d.ip1.shape[0],), nz, jnp.float32))
        spill = jnp.floor(4.0 * g.sigma + 0.5)
        return (g.content_wh[:, 0] + 2.0 * spill,
                g.content_wh[:, 1] + 2.0 * spill, 4.0 * g.sigma)

    def needs(d):
        out = one(d, 0.0)
        if noise_max > 0:
            for nz in (-noise_max, noise_max):
                out = [jnp.maximum(a, b) for a, b in zip(out, one(d, nz))]
        return out

    return [np.asarray(x) for x in jax.jit(jax.vmap(needs))(drops)]


def _port(drops):
    return interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                         device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fitted_ladder_equals_raintpu(case):
    settings, drops = _sample(case)
    tdrops = _port(drops)
    valid = np.asarray(drops.valid)
    got = [t.numpy() for t in trz.fit_needs(tdrops, TEX_HW, (W, H),
                                            settings)]
    for name, g, w in zip(("nw", "nh", "s4"), got,
                          _jax_needs(drops, settings)):
        np.testing.assert_allclose(g[valid], w[valid], atol=1e-5, rtol=0,
                                   err_msg=name)
    want = jrz.fit_raster_config(drops, TEX_HW, (W, H), settings)
    fitted = trz.fit_raster_config(tdrops, TEX_HW, (W, H), settings)
    assert dataclasses.asdict(fitted) == dataclasses.asdict(want)
    assert len(fitted.buckets) >= 2
    if case == "white":
        # No defocus: every rung keeps the radius floor.
        assert {b.radius for b in fitted.buckets} == {2}


def test_empty_population_falls_back_to_raintpus_ladder():
    settings, drops = _sample("physics")
    drops = dataclasses.replace(drops, valid=jnp.zeros_like(drops.valid))
    want = jrz.fit_raster_config(drops, TEX_HW, (W, H), settings)
    got = trz.fit_raster_config(_port(drops), TEX_HW, (W, H), settings)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.buckets == trz.RasterConfig.default(64).buckets
