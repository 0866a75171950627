"""The port's golden render path against raintpu's XLA path and against
the reference-faithful NumPy/cv2 renderer.

The golden path rasterizes every drop into a patch of its rung and
scatter-adds the patches into the fields: ``render_frame``,
``render_frames(composite_mode="xla")``, ``drop_patches`` ->
``rasterize_frame_drops`` (the DCT series, or a bilinear gather of the
textures and ``variable_separable_blur``) and ``composite_drops``.
Inputs are made with numpy from a seed (drops by raintpu's simulator
and by hand, passed to the port as arrays). raintpu's texture picks are
fixed by monkeypatching its ``select_textures`` (as
tests/test_golden_parity.py does), its streak noise is its own draw,
and the port gets both as data.

Bars: the blur 1e-6; patches and fields 1e-5, with anchors, slots,
validity and overflow equal; renders 2e-4 (raintpu's own bar between
its fused and XLA paths, tests/test_pallas_batched.py), envmaps 1e-5;
against the reference renderer, test_golden_parity.py's bars.

One discontinuity of the model is counted, not compared: a drop's alpha
below ALPHA_CUTOFF (2e-4) is zeroed. Two float32 implementations differ
by ~1e-7 before the cut (cos, tanh and the modal re-analysis's sums
round differently in XLA and PyTorch), so a pixel whose alpha sits
within that of the cutoff can be kept on one side and zeroed on the
other: it then misses the bar by one cutoff. At most CUTOFF_FLIPS such
pixels a comparison may do so (the image and saturation mask are not
compared there), each alpha off by one cutoff; every other pixel holds
the bar. (Measured: the heavily defocused Big drop's tail in this
file's scene, raintpu 2.000137e-4, the port 1.99935e-4 before the cut:
one pixel, its image 3.13e-4 off.)
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.data.textures import procedural_streak_database, texture_bank
from raintpu.ops import blur as jblur
from raintpu.ops import composite as jcomp
from raintpu.ops import rasterize as jrz
from raintpu.particles import schema as jschema
from raintpu.physics.simulator import SimConfig, simulate_frame
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.ops import blur as tblur
from raintpu_torch.ops import composite as tcomp
from raintpu_torch.ops import fog as tfog
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.ops.fused_raster import ALPHA_CUTOFF
from raintpu_torch.particles.schema import pack_drop_batch
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "ref_numpy"))

from reference_renderer import render_reference  # noqa: E402

H, W, CAP = 96, 160, 64
PATCH_ATOL = 1e-5
RENDER_ATOL = 2e-4
# 24 slots for the scene's 30 drops: every path overflows.
LADDER = ((48, 32, 6, 12, 12, 6, 3), (128, 96, 16, 12, 16, 8, 4))
# tests/test_golden_parity.py's ladder.
PARITY_LADDER = ((48, 32, 6, 64), (128, 96, 16, 16))
# Pixels a comparison may count as kept by ALPHA_CUTOFF on one side only
# (see the module docstring).
CUTOFF_FLIPS = 2


def cutoff_flips(got, want, atol, name=""):
    """The values of an alpha (a patch or a rain mask) that miss the bar
    atol: each must be a cutoff flip — off by one ALPHA_CUTOFF, within
    1e-6 — and there may be at most CUTOFF_FLIPS. Returns their mask."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flips = ~(d <= atol)
    jumps = d[flips]
    assert flips.sum() <= CUTOFF_FLIPS and (
        np.abs(jumps - ALPHA_CUTOFF) <= 1e-6).all(), (
        f"{name}: {int(flips.sum())} values off by more than {atol} "
        f"({sorted(jumps.tolist())[-3:]}); at most {CUTOFF_FLIPS} may be, "
        f"each by one ALPHA_CUTOFF")
    return flips


def assert_render_close(got, want, names, atol=2e-4):
    """The FrameOutputs ``got`` and ``want`` on ``names`` within atol,
    but for the rain mask's cutoff flips (:func:`cutoff_flips`), where
    the image and the saturation mask are not compared."""
    flips = cutoff_flips(got.rain_mask, want.rain_mask, atol, "rain_mask")
    for name in names:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        keep = ~flips.reshape(flips.shape + (1,) * (g.ndim - flips.ndim))
        np.testing.assert_allclose(np.where(keep, g, 0), np.where(keep, w, 0),
                                   atol=atol, err_msg=name)


def _streaks(rng, n, width, z, length):
    """n streaks at random places of the frame, hanging down from their
    top end by ``length`` px at up to ~15 degrees, ``width`` px wide,
    ``z`` m from the camera (ranges), through the record derivation of
    the XML path (raintpu's finalize_raw_streaks and cull_to_frame)."""
    x = rng.uniform(15, W - 25, n)
    y = rng.uniform(5, H - 30, n)
    ln = rng.uniform(*length, n)
    ang = rng.uniform(-0.25, 0.25, n)
    top = np.stack([x, H - y], -1)                 # simulator y (bottom up)
    bottom = np.stack([x + ln * np.sin(ang), H - (y + ln * np.cos(ang))], -1)
    zz = rng.uniform(*z, n)
    wp1 = np.stack([(x - W / 2) / 500.0 * zz, np.ones(n), -zz], -1)
    iw = rng.uniform(*width, n)
    rec = jschema.finalize_raw_streaks(
        bottom, top, iw, iw * rng.uniform(0.8, 1.0, n), wp1,
        wp1 + np.array([0.0, -0.02, 0.0]), (W, H))
    return jschema.cull_to_frame(rec, (W, H))


def _frame_fields(seed, n_small):
    """One frame's drops as numpy DropBatch fields packed to CAP:
    ``n_small`` Small/Medium streaks 1.5-5 m away and four close-range
    Big ones (the perspective warp and heavy defocus, as
    test_golden_parity.py's big-drop scene makes them)."""
    rng = np.random.RandomState(seed)
    small = _streaks(rng, n_small, (1.0, 3.9), (1.5, 5.0), (6.0, 40.0))
    big = _streaks(rng, 4, (4.5, 7.0), (0.6, 1.4), (10.0, 16.0))
    assert (big["drop_type"] == 0).all() and len(big["ip1"]) == 4
    assert (small["drop_type"] > 0).any() and len(small["ip1"]) > 10
    rec = {k: np.concatenate([small[k], big[k]]) for k in small}
    return interop.numpy_fields(jschema.pack_drop_batch(rec, CAP))


def _frame(seed):
    """A frame and its depth (sky to road, as test_golden_parity.py's)."""
    rng = np.random.RandomState(seed)
    yy = np.linspace(0, 1, H)[:, None] * np.ones((1, W))
    bg = np.clip(np.stack([0.35 + 0.3 * yy + rng.rand(H, W) * 0.05,
                           0.4 + 0.25 * yy, 0.55 - 0.15 * yy], -1),
                 0, 1).astype(np.float32)
    return bg, (5 + 150 * (1 - yy)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """A 160x96 frame with 30 drops, 4 of them Big (numpy fields), the
    procedural texture bank on both sides, and fixed texture picks."""
    fields = _frame_fields(3, 26)
    bg, depth = _frame(2)
    db = procedural_streak_database()
    bank = texture_bank(db)
    tex = (np.arange(CAP) * 7) % db.textures.shape[0]
    return dict(fields=fields, bg=bg, depth=depth, db=db, bank=bank,
                tbank=interop.texture_bank_from_numpy(
                    bank.raw, bank.ay, bank.bx, device="cpu"),
                tex=tex.astype(np.int32), raster={})


def _jax_drops(fields):
    return jschema.DropBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


def _port_drops(fields):
    return interop.drop_batch_from_numpy(fields, device="cpu")


def _settings(**kw):
    return dataclasses.replace(
        RenderSettings(camera=CameraSettings(wh=(W, H), ccd_wh=(W, H))),
        **kw)


def _ladders(ladder, **kw):
    return (jrz.RasterConfig(
                buckets=tuple(jrz.BucketSpec(*b) for b in ladder), **kw),
            trz.RasterConfig(
                buckets=tuple(trz.BucketSpec(*b) for b in ladder), **kw))


def _fix_textures(monkeypatch, tex):
    """raintpu's texture picks become ``tex`` (the port takes them as
    tex_idx)."""
    def fixed(drops, edges, key, offset=0):
        n = drops.ratio.shape[0]
        return jnp.asarray(tex[offset:offset + n])

    monkeypatch.setattr(jrz, "select_textures", fixed)


def test_variable_separable_blur_matches_raintpu():
    """Per-patch sigmas, some past radius/4 (taps cut at the radius),
    one at 0 (the 1e-6 floor: the identity)."""
    rng = np.random.RandomState(0)
    patches = rng.rand(6, 23, 17).astype(np.float32)
    rows = np.array([0.0, 0.4, 1.3, 2.5, 4.0, 9.0], np.float32)
    cols = np.array([0.0, 4.5, 2.0, 1.25, 0.65, 0.2], np.float32)
    want = np.asarray(jax.jit(jblur.variable_separable_blur,
                              static_argnums=3)(
        jnp.asarray(patches), jnp.asarray(rows), jnp.asarray(cols), 6))
    got = tblur.variable_separable_blur(
        torch.as_tensor(patches), torch.as_tensor(rows),
        torch.as_tensor(cols), 6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0], patches[0], atol=1e-6)


def _raster_both(scene, mode, defocus):
    """rasterize_frame_drops on both sides (kept in the scene), on the
    scene's drops with streak noise and a NaN payload in the last
    (invalid) row, which the invalid slots point at."""
    if (mode, defocus) in scene["raster"]:
        return scene["raster"][mode, defocus]
    fields = {k: v.copy() for k, v in scene["fields"].items()}
    assert not fields["valid"][-1]
    fields["ip1"][-1] = np.nan
    fields["wp1"][-1] = np.nan
    noise = np.random.RandomState(1).randn(CAP).astype(np.float32) * 6.0
    jcfg, tcfg = _ladders(LADDER, texture_mode=mode)
    bank, tbank = scene["bank"], scene["tbank"]
    geo = dict(focal_m=6e-3, f_number=6.0, focus_plane=6.0,
               coc_pixsize=4.65e-6, apply_defocus=defocus)
    td = _port_drops(fields)
    tgeom = trz.drop_geometry(td, tuple(tbank.raw.shape[1:]), (W, H),
                              noise_deg=torch.as_tensor(noise), **geo)

    @jax.jit
    def jax_raster(jd, noise, tex):
        jgeom = jrz.drop_geometry(jd, bank.raw.shape[1:], (W, H),
                                  noise_deg=noise, **geo)
        return jrz.rasterize_frame_drops(
            jd, jgeom, bank.raw, tex, (W, H), jcfg, defocus,
            fourier=(bank.ay, bank.bx))

    want = jax_raster(_jax_drops(fields), jnp.asarray(noise),
                      jnp.asarray(scene["tex"]))
    got = trz.rasterize_frame_drops(
        td, tgeom, tbank.raw, torch.as_tensor(scene["tex"]), (W, H), tcfg,
        defocus, fourier=(tbank.ay, tbank.bx))
    scene["raster"][mode, defocus] = want, got
    return want, got


@pytest.mark.parametrize("defocus", [True, False],
                         ids=["defocus", "sharp"])
@pytest.mark.parametrize("mode", ["fourier", "gather"])
def test_rasterize_frame_drops_matches_raintpu(scene, mode, defocus):
    want, got = _raster_both(scene, mode, defocus)
    assert len(got) == len(want) == len(LADDER)
    assert sum(int(w.overflow) for w in want) > 0, "the ladder must overflow"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.anchor.numpy(), np.asarray(w.anchor))
        np.testing.assert_array_equal(g.drop_idx.numpy(),
                                      np.asarray(w.drop_idx))
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        assert int(g.overflow) == int(w.overflow)
        p = g.patches.numpy()
        assert np.isfinite(p).all()
        w = np.asarray(w.patches)
        flips = cutoff_flips(p, w, PATCH_ATOL, "patches")
        assert (np.minimum(p, w)[flips] == 0).all()
    assert sum(float(g.patches.sum()) for g in got) > 10.0


@pytest.mark.parametrize("sat", [False, True], ids=["plain", "saturation"])
def test_composite_drops_matches_raintpu(scene, sat):
    """raintpu's buckets (the series, defocused) scattered on both
    sides, with random per-drop rows and a NaN in the invalid rows'."""
    want_b, _ = _raster_both(scene, "fourier", True)
    rng = np.random.RandomState(4)
    lo = rng.rand(CAP).astype(np.float32) * 0.2
    add = rng.rand(CAP, 3).astype(np.float32)
    gains = rng.rand(CAP, 3).astype(np.float32) * 2.0
    for a in (lo, add, gains):
        a[~scene["fields"]["valid"]] = np.nan
    want = jax.jit(lambda b, lo, add, gains: jcomp.composite_drops(
        (H, W), b, lo, add, sat_rgb_all=gains if sat else None))(
        want_b, jnp.asarray(lo), jnp.asarray(add), jnp.asarray(gains))
    port_b = [trz.RasterBucket(
        patches=torch.as_tensor(np.array(b.patches)),
        anchor=torch.as_tensor(np.array(b.anchor)),
        drop_idx=torch.as_tensor(np.array(b.drop_idx)).long(),
        valid=torch.as_tensor(np.array(b.valid)),
        overflow=torch.as_tensor(np.array(b.overflow))) for b in want_b]
    got = tcomp.composite_drops(
        (H, W), port_b, torch.as_tensor(lo), torch.as_tensor(add),
        sat_rgb_all=torch.as_tensor(gains) if sat else None)
    assert got.alpha.shape == (H, W) and float(got.alpha.sum()) > 10.0
    for name in ("alpha", "log_att", "additive", "sat"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
            continue
        g = getattr(got, name).numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=PATCH_ATOL,
                                   err_msg=name)
    # The planes round-trip through their stacked form.
    again = tcomp.FieldMaps.from_planes(got.planes())
    for name in ("alpha", "log_att", "additive", "sat"):
        if getattr(got, name) is not None:
            assert torch.equal(getattr(again, name), getattr(got, name))


# render_frame cases: (settings, raster config, PipelineConfig) kwargs.
CASES = {
    "physics": (dict(), dict(),
                dict(compute_saturation_mask=True, save_envmap=True)),
    "white": (dict(rendering_strategy="white"), dict(),
              dict(compute_saturation_mask=True)),
    "naive_db": (dict(rendering_strategy="naive_db"), dict(), dict()),
    "noise_pano": (dict(noise_scale=1.0, noise_std=8.0, env_type="pano"),
                   dict(), dict(save_envmap=True)),
    "gather": (dict(), dict(texture_mode="gather", supersample=2),
               dict(compute_saturation_mask=True)),
}


def _render_case(scene, case, composite_mode="fused"):
    """(port PipelineConfig, render_frame's keyword data, raintpu's
    render of the case (its texture picks fixed to the scene's by the
    caller's monkeypatch; its streak noise its own draw, also returned
    to the port as data))."""
    st_kw, raster_kw, cfg_kw = CASES[case]
    settings = _settings(**st_kw)
    jr, tr = _ladders(LADDER, **raster_kw)
    base = dict(settings=settings, image_hw=(H, W), fallrate=100.0,
                env_downsample=2, **cfg_kw)
    jcfg = jframe.PipelineConfig(raster=jr, **base)
    tcfg = tframe.PipelineConfig(raster=tr, composite_mode=composite_mode,
                                 **base)
    key = jax.random.PRNGKey(5)
    data = dict(tex_idx=torch.as_tensor(scene["tex"]))
    pano = None
    if settings.noise_scale * settings.noise_std:
        nkeys = jrz.per_drop_keys(jax.random.split(key)[1], CAP, 0)
        noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, ()))(
            nkeys)) * settings.noise_std * settings.noise_scale
        assert np.abs(noise).max() > 1.0
        data["noise_deg"] = torch.as_tensor(noise)
    if settings.env_type == "pano":
        pano = np.random.RandomState(6).rand(32, 64, 3).astype(np.float32)
        data["pano"] = torch.as_tensor(pano)
    want = jax.jit(lambda *a: jframe.render_frame(*a, jcfg, pano=pano))(
        jnp.asarray(scene["bg"]), jnp.asarray(scene["depth"]),
        _jax_drops(scene["fields"]), scene["bank"],
        jnp.asarray(scene["db"].bin_edges), key)
    return tcfg, data, want


@pytest.mark.parametrize("case", list(CASES))
def test_render_frame_matches_raintpu(scene, monkeypatch, case):
    """The port's render_frame against raintpu's on one frame: the
    physics strategy (saturation mask, envmap), 'white', 'naive_db',
    streak noise with a captured pano, and the texture gather. The
    port's config asks for the fused path: render_frame takes the
    golden path whatever it says."""
    _fix_textures(monkeypatch, scene["tex"])
    tcfg, data, want = _render_case(scene, case)
    got = tframe.render_frame(
        torch.as_tensor(scene["bg"]), torch.as_tensor(scene["depth"]),
        _port_drops(scene["fields"]), scene["tbank"],
        torch.as_tensor(scene["db"].bin_edges), tcfg, **data)
    assert got.rain_mask.shape == (H, W)
    assert float(got.rain_mask.sum()) > 10.0
    names = [n for n in ("rain_mask", "rainy_image", "saturation_mask")
             if getattr(want, n) is not None]
    assert (got.saturation_mask is None) == (want.saturation_mask is None)
    assert_render_close(got, want, names, RENDER_ATOL)
    if tcfg.save_envmap:
        np.testing.assert_allclose(got.envmap.numpy(),
                                   np.asarray(want.envmap), atol=1e-5)
    else:
        assert got.envmap is None
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert int(got.overflow.sum()) > 0


def test_render_frame_gathers_plain_textures(scene):
    """Textures given as a plain (K, TH, TW) tensor (no DCT factors)
    take the gather, as raintpu's drop_patches does: the render equals
    texture_mode "gather" on the bank; render_frame equals
    render_frames' golden path on a batch of that one frame."""
    tcfg = tframe.PipelineConfig(
        settings=_settings(), image_hw=(H, W), fallrate=100.0,
        raster=_ladders(LADDER)[1], env_downsample=2)
    gather = dataclasses.replace(tcfg, raster=dataclasses.replace(
        tcfg.raster, texture_mode="gather"), composite_mode="xla")
    args = (torch.as_tensor(scene["bg"]), torch.as_tensor(scene["depth"]),
            _port_drops(scene["fields"]))
    tex_idx = torch.as_tensor(scene["tex"])
    edges = torch.as_tensor(scene["db"].bin_edges)
    plain = tframe.render_frame(*args, scene["tbank"].raw, edges, tcfg,
                                tex_idx=tex_idx)
    banked = tframe.render_frame(*args, scene["tbank"], edges, gather,
                                 tex_idx=tex_idx)
    batched = tframe.render_frames(
        *(t[None] for t in args[:2]), args[2].map(lambda t: t[None]),
        scene["tbank"], edges, gather, tex_idx=tex_idx[None])
    assert float(plain.rain_mask.sum()) > 10.0
    for name in ("rain_mask", "rainy_image", "overflow"):
        assert torch.equal(getattr(plain, name), getattr(banked, name))
        assert torch.equal(getattr(batched, name)[0], getattr(banked, name))


def _batch_of_two(scene):
    """The scene's frame and a second one (other drops, frame, depth)."""
    second = _frame_fields(8, 20)
    fields = {k: np.stack([scene["fields"][k], second[k]])
              for k in scene["fields"]}
    rng = np.random.RandomState(7)
    bg = np.stack([scene["bg"], rng.rand(H, W, 3).astype(np.float32)])
    depth = np.stack([scene["depth"],
                      (rng.rand(H, W) * 40 + 3).astype(np.float32)])
    return fields, bg, depth


def test_render_frames_xla_matches_raintpu(scene):
    """render_frames with composite_mode "xla" at batch 2, with the
    saturation planes, against raintpu's; the texture picks are
    raintpu's own draws from its keys."""
    fields, bg, depth = _batch_of_two(scene)
    jr, tr = _ladders(LADDER)
    base = dict(settings=_settings(), image_hw=(H, W), fallrate=100.0,
                env_downsample=2, compute_saturation_mask=True,
                composite_mode="xla")
    jcfg = jframe.PipelineConfig(raster=jr, **base)
    tcfg = tframe.PipelineConfig(raster=tr, **base)
    jd = _jax_drops(fields)
    edges = jnp.asarray(scene["db"].bin_edges)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    want = jframe.render_frames(jnp.asarray(bg), jnp.asarray(depth), jd,
                                scene["bank"], edges, keys, jcfg)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(jd, keys)
    got = tframe.render_frames(
        torch.as_tensor(bg), torch.as_tensor(depth), _port_drops(fields),
        scene["tbank"], torch.as_tensor(scene["db"].bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))
    assert got.rain_mask.shape == (2, H, W)
    assert (got.rain_mask.sum(dim=(1, 2)) > 1.0).all()
    assert_render_close(got, want,
                        ("rain_mask", "rainy_image", "saturation_mask"),
                        RENDER_ATOL)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


@pytest.mark.parametrize("strategy", [None, "white"],
                         ids=["physics", "white"])
def test_xla_and_fused_agree(scene, strategy):
    """On the CPU the port's two field paths (the fused kernel's plain
    version; patches and scatter) agree within raintpu's bar between
    its own two, 8 planes and streak noise included."""
    fields, bg, depth = _batch_of_two(scene)
    tr = _ladders(LADDER)[1]
    cfg = tframe.PipelineConfig(
        settings=_settings(rendering_strategy=strategy, noise_scale=1.0,
                           noise_std=5.0),
        image_hw=(H, W), fallrate=100.0, raster=tr, env_downsample=2,
        compute_saturation_mask=True)
    args = (torch.as_tensor(bg), torch.as_tensor(depth),
            _port_drops(fields), scene["tbank"],
            torch.as_tensor(scene["db"].bin_edges))
    outs = {mode: tframe.render_frames(
                *args, dataclasses.replace(cfg, composite_mode=mode),
                generator=torch.Generator().manual_seed(3))
            for mode in ("fused", "xla")}
    assert float(outs["xla"].rain_mask.sum()) > 10.0
    assert_render_close(outs["xla"], outs["fused"],
                        ("rain_mask", "rainy_image", "saturation_mask"),
                        RENDER_ATOL)
    assert torch.equal(outs["xla"].overflow, outs["fused"].overflow)


@pytest.mark.parametrize("mode,want", [("auto", "fused"), ("fused", "fused"),
                                       ("xla", "xla"), ("pallas", None),
                                       ("gather", None)])
def test_composite_mode_resolves(mode, want):
    """'auto' is the fused path on every device; any mode but the three
    raises raintpu's ValueError ('pallas' too: retired there)."""
    cfg = tframe.PipelineConfig.build(_settings(), (H, W), 10.0,
                                      composite_mode=mode)
    if want is None:
        with pytest.raises(ValueError, match="composite_mode"):
            cfg.resolved_composite_mode()
    else:
        assert cfg.resolved_composite_mode() == want


def test_render_frame_matches_reference_renderer():
    """tests/test_golden_parity.py's scene and bars, the port's
    render_frame against the reference-faithful renderer."""
    import cv2

    rng = np.random.RandomState(2)
    yy = np.linspace(0, 1, H)[:, None] * np.ones((1, W))
    bg = np.clip(np.stack([0.35 + 0.3 * yy + rng.rand(H, W) * 0.05,
                           0.4 + 0.25 * yy, 0.55 - 0.15 * yy], -1),
                 0, 1).astype(np.float32)
    depth = (5 + 150 * (1 - yy)).astype(np.float32)
    sim = SimConfig(image_wh=(W, H), focal_px=(500.0, 500.0),
                    exposure_s=2e-3, capacity=64, z_max=7.0)
    batch = jax.jit(lambda k: simulate_frame(k, sim, 100.0, 6.0, 2e-3, 1.0))(
        jax.random.PRNGKey(11))
    v = np.asarray(batch.valid)
    rec = {k: np.asarray(getattr(batch, k))[v]
           for k in ("ip1", "ip2", "iw1", "iw2", "wp1", "wp2",
                     "max_width", "length", "ratio", "drop_type")}
    assert len(rec["ip1"]) >= 8, "scene needs a handful of drops"
    db = procedural_streak_database()
    n = len(rec["ip1"])
    tex_choice = (np.arange(n) * 7) % db.textures.shape[0]

    exposure_s = 2e-3
    fogged = tfog.fog_rain_layer(
        torch.as_tensor(bg), torch.as_tensor(depth), rain_intensity=100.0,
        f_number=6.0, exposure_s=exposure_s, camera_gain=20.0).numpy()
    ref_img, ref_mask, ref_sat = render_reference(
        bg.astype(np.float64), fogged.astype(np.float64), rec,
        db.textures.astype(np.float64), tex_choice,
        exposure_s=exposure_s, focal_m=6e-3)

    cfg = tframe.PipelineConfig(
        settings=_settings(), image_hw=(H, W), fallrate=100.0,
        raster=_ladders(PARITY_LADDER)[1], env_downsample=2,
        compute_saturation_mask=True)
    tex_idx = np.zeros(64, np.int64)
    tex_idx[:n] = tex_choice
    bank = texture_bank(db)
    out = tframe.render_frame(
        torch.as_tensor(bg), torch.as_tensor(depth),
        pack_drop_batch(rec, 64, device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                        device="cpu"),
        torch.as_tensor(db.bin_edges), cfg,
        tex_idx=torch.as_tensor(tex_idx))
    got_img = out.rainy_image.numpy()
    got_mask = out.rain_mask.numpy()
    got_sat = out.saturation_mask.numpy()
    assert int(out.overflow.sum()) == 0

    gm = got_mask > 0.03
    rm = ref_mask > 0.03
    union = (gm | rm).sum()
    iou = (gm & rm).sum() / union if union else 1.0
    assert union > 100, "scene must contain visible rain"
    assert iou >= 0.9, f"mask IoU {iou:.3f}"
    k = np.ones((3, 3), np.uint8)
    gd = cv2.dilate(gm.astype(np.uint8), k) > 0
    rd = cv2.dilate(rm.astype(np.uint8), k) > 0
    iou_tol = ((gm & rd) | (rm & gd)).sum() / union
    assert iou_tol >= 0.99, f"1px-tolerant mask IoU {iou_tol:.4f}"
    corr = np.corrcoef(got_mask.ravel(), ref_mask.ravel())[0, 1]
    assert corr >= 0.95, f"mask correlation {corr:.3f}"
    diff = np.abs(got_img - ref_img).mean()
    assert diff < 0.02, diff
    ratio = got_mask.sum() / max(ref_mask.sum(), 1e-9)
    assert 0.7 < ratio < 1.4, ratio
    assert got_sat.shape == (H, W, 3)
    assert np.abs(got_sat - ref_sat).mean() < 0.02
    sat_ratio = got_sat.sum() / max(ref_sat.sum(), 1e-9)
    assert 0.7 < sat_ratio < 1.4, sat_ratio
    corr_sat = np.corrcoef(got_sat.mean(-1).ravel(),
                           ref_sat.mean(-1).ravel())[0, 1]
    assert corr_sat >= 0.9, corr_sat
