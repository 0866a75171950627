"""The port's drop simulator and drop schema against raintpu.

torch.Generator draws differ from jax.random's, so the simulator is
held to statistics: the Poisson count's mean against the expected
count, the validity rules on every drop, and two-sample bounds between
the port's and the JAX simulator's depth and width distributions. The
schema's host-side helpers and compaction are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from raintpu.particles import schema as jschema
from raintpu.physics import simulator as jsim
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.particles import schema as tschema
from raintpu_torch.physics import simulator as tsim
from torch_cpu_threads import one_torch_thread  # noqa: F401

# The KITTI camera at 10 mm/hr (the benchmark's weather), as bench.py
# configures its simulator.
KITTI = RenderSettings(camera=CameraSettings())
W, H = KITTI.camera.wh
FRAMES = 200
FALLRATE = 10.0
# A small camera for the exact schema checks.
SMALL_KW = dict(image_wh=(96, 48), focal_px=(300.0, 300.0),
                exposure_s=2e-3, z_max=5.0)


def _port_frames(monkeypatch=None, counts=None):
    cfg = tsim.SimConfig.from_settings(KITTI, capacity=512)
    if monkeypatch is not None:
        poisson = torch.poisson

        def spy(rate, generator=None):
            out = poisson(rate, generator=generator)
            counts.append(out.clone())
            return out

        monkeypatch.setattr(torch, "poisson", spy)
    gen = torch.Generator().manual_seed(7)
    ones = torch.ones(FRAMES)
    return cfg, tsim.simulate_frames(gen, cfg, ones * FALLRATE, ones * 8.0,
                                     ones * KITTI.camera.exposure_s, ones)


def test_count_is_poisson_of_expected(monkeypatch):
    counts = []
    cfg, drops = _port_frames(monkeypatch, counts)
    lam = tsim.expected_drop_count(cfg, FALLRATE)
    # Well inside capacity, so the clamp never cuts a draw.
    assert 20 < lam < cfg.capacity - 5 * np.sqrt(lam), lam
    raw = torch.cat(counts).double()
    # Mean of FRAMES Poisson(lam) draws: within 5 standard errors.
    assert abs(raw.mean().item() - lam) < 5 * np.sqrt(lam / FRAMES)
    assert abs(raw.var().item() / lam - 1.0) < 0.35
    n_valid = drops.count()
    assert bool((n_valid.double() <= raw).all())


def test_validity_rules():
    cfg, d = _port_frames()
    v = d.valid
    assert v.any()
    m = max(W, H)
    mw, ln = d.max_width[v], d.length[v]
    assert bool(((mw >= 1) & (mw < m) & (ln >= 1) & (ln < m)).all())

    def inside(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < W)
                & (p[..., 1] >= 0) & (p[..., 1] < H))

    assert bool((inside(d.ip1[v]) | inside(d.ip2[v])).all())
    assert bool((d.ip1 == torch.round(d.ip1)).all())
    assert bool((d.wp1[..., 2][v] > 0).all())
    want_type = torch.where(mw >= 4, 0, torch.where(mw > 1, 1, 2))
    assert torch.equal(d.drop_type[v].long(), want_type.long())
    assert torch.equal(d.max_width[v],
                       torch.maximum(d.iw1, d.iw2)[v].to(torch.int32))
    for f in dataclasses.fields(d):
        t = getattr(d, f.name)
        assert t.shape[:2] == (FRAMES, cfg.capacity), f.name
        assert t.dtype in (torch.float32, torch.int32, torch.bool), f.name


def test_distributions_match_jax():
    _, t = _port_frames()
    jcfg = jsim.SimConfig.from_settings(KITTI, capacity=512)
    ones = jnp.ones(FRAMES)
    j = jsim.simulate_frames(jax.random.PRNGKey(7), jcfg, ones * FALLRATE,
                             ones * 8.0, ones * KITTI.camera.exposure_s,
                             ones)
    jv = np.asarray(j.valid)
    tv = t.valid.numpy()
    # Mean valid count per frame: two-sample bound on the difference.
    jc, tc = jv.sum(1), tv.sum(1)
    se = np.sqrt(jc.var() / FRAMES + tc.var() / FRAMES)
    assert abs(jc.mean() - tc.mean()) < 5 * se
    # Depth and image width of the valid drops: two-sample KS tests.
    for name, jx, tx in (
            ("depth", np.asarray(j.wp1)[..., 2][jv], t.wp1[..., 2][t.valid]),
            ("width", np.asarray(j.iw1)[jv], t.iw1[t.valid]),
            ("length", np.asarray(j.length)[jv], t.length[t.valid])):
        p = ks_2samp(jx, tx.numpy()).pvalue
        assert p > 1e-3, (name, p)


def test_simulate_frame_is_one_frame():
    cfg = tsim.SimConfig.from_settings(KITTI, capacity=512)
    d = tsim.simulate_frame(torch.Generator().manual_seed(1), cfg,
                            FALLRATE, 8.0, device="cpu")
    assert d.ip1.shape == (512, 2) and d.valid.shape == (512,)
    lam = tsim.expected_drop_count(cfg, FALLRATE)
    assert 0 < int(d.count()) <= lam + 5 * np.sqrt(lam)


def _jax_batch(rng, b=2, n=24):
    """A JAX DropBatch with a random validity pattern."""
    sim = jsim.SimConfig(capacity=n, **SMALL_KW)
    d = jsim.simulate_frames(jax.random.PRNGKey(3), sim,
                             jnp.full(b, 150.0), jnp.full(b, 5.0),
                             jnp.full(b, 2e-3), jnp.ones(b))
    return dataclasses.replace(
        d, valid=jnp.asarray(rng.rand(b, n) < 0.6) & d.valid)


@pytest.mark.parametrize("capacity", [8, 40])
def test_compact_drop_batch(rng, capacity):
    jd = _jax_batch(rng)
    td = interop.drop_batch_from_numpy(interop.numpy_fields(jd),
                                       device="cpu")
    want = jax.vmap(lambda d: jschema.compact_drop_batch(d, capacity))(jd)
    got = tschema.compact_drop_batch(td, capacity)
    for name, arr in interop.numpy_fields(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)
    assert got.capacity == capacity
    np.testing.assert_array_equal(got.count().numpy(),
                                  np.asarray(want.count()))


def test_host_record_helpers(rng):
    n = 64
    w, h = SMALL_KW["image_wh"]
    raw = dict(ip1=rng.uniform(-20, 120, (n, 2)),
               ip2=rng.uniform(-20, 120, (n, 2)),
               iw1=rng.uniform(0, 6, n), iw2=rng.uniform(0, 6, n),
               wp1=rng.uniform(-3, 3, (n, 3)), wp2=rng.uniform(-3, 3, (n, 3)))
    for kw in (dict(render_scale=2.0), dict(rescale=0.5)):
        want = jschema.finalize_raw_streaks(**raw, image_wh=(w, h), **kw)
        got = tschema.finalize_raw_streaks(**raw, image_wh=(w, h), **kw)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = jschema.cull_to_frame(want, (w, h))
    got = tschema.cull_to_frame(got, (w, h))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cap = len(want["ip1"]) - 3       # over capacity: keeps the widest
    jp = interop.numpy_fields(jschema.pack_drop_batch(want, cap))
    tp = tschema.pack_drop_batch(got, cap, device="cpu")
    for k, arr in jp.items():
        np.testing.assert_array_equal(getattr(tp, k).numpy(), arr,
                                      err_msg=k)


def test_interop_roundtrip(rng):
    jd = _jax_batch(rng)
    fields = interop.numpy_fields(jd)
    td = interop.drop_batch_from_numpy(fields, device="cpu")
    for k, arr in fields.items():
        np.testing.assert_array_equal(getattr(td, k).numpy(), arr)
    with pytest.raises(KeyError):
        interop.drop_batch_from_numpy({"ip1": fields["ip1"]})
    bank = interop.texture_bank_from_numpy(
        rng.rand(3, 8, 4), rng.rand(3, 2, 5), rng.rand(3, 2, 3),
        device="cpu")
    assert bank.raw.dtype == torch.float32 and bank.ay.shape == (3, 2, 5)
