"""Heavy rain: one KITTI frame at 200 mm/hr, the port against raintpu.

KITTI's camera (``raintpu/data/datasets/kitti.py``) at 375x1242, the
paper's top rate: about 2,900 valid drops in the frame, simulated by
raintpu at capacity 8192 and handed to both render jobs with the same
texture picks (``test_torch_pipeline._jobs``), the saturation mask and
the envmap saved.

At this density raintpu's job differs from itself. It evaluates the
photometry envmap's pixel directions (``ops/solid_angle.
pixel_directions``) inside its jitted render, where XLA's fused cos and
sin round otherwise than eager evaluation (up to 9.5e-7 here). A texel
that lies on a drop's cone edge to within that rounding then falls
inside the cone on one side only, and that drop's colour moves by about
0.1%: its saturation-mask sum moves by up to ~4e-4, over the pipeline
bar of 2e-4. The port computes the directions as raintpu's eager
evaluation does. Held here: the port's drop colours equal raintpu's
eager ones; the jitted ones differ only at drops with a texel on the
cone edge, and not with the direction map alone evaluated eagerly; the
port's job is off raintpu's saturation mask as raintpu runs, and with
raintpu's maps taken from its eager evaluation (the direction map and
the envmap's index maps, through a monkeypatch) the two jobs agree at
test_torch_pipeline's bars but for the rain mask's cutoff flips
(test_torch_golden). Run with -s, the tests print the differences.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.data.datasets import kitti
from raintpu.ops import envmap as jenv
from raintpu.ops import photometry as jph
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.render import frame as jframe
from raintpu.render import pipeline as jpipe
from raintpu_torch import interop
from raintpu_torch.ops import photometry as tph
from raintpu_torch.render import camera as tcam
from raintpu_torch.render import frame as tframe
from raintpu_torch.render import pipeline as tpipe
from test_torch_golden import assert_render_close
from test_torch_pipeline import _jobs, _recording
from torch_cpu_threads import one_torch_thread  # noqa: F401

H, W = 375, 1242
FALLRATE = 200.0
CAPACITY = 8192
# A drop colour off by more than this (relative) between two sides.
COLOUR_RTOL = 1e-4
SETTINGS = {**kitti.settings(), "depth_scale": 1, "render_scale": 1,
            "sim_mode": "normal", "sim_duration": 0.5, "sim_steps": {},
            "sim_hz": 2000, "sequences": {}}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The frame on disk (customdb-style .npy) and its drops."""
    tmp = str(tmp_path_factory.mktemp("heavy_rain"))
    rng = np.random.RandomState(1)
    bg = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    depth = (rng.rand(H, W) * 60 + 3).astype(np.float32)
    for sub, arr in (("rgb", bg), ("depth", depth)):
        os.makedirs(os.path.join(tmp, "seqA", sub))
        np.save(os.path.join(tmp, "seqA", sub, "000000.npy"), arr)
    cfg = jsim.SimConfig.from_settings(jcam.settings_from_dict(SETTINGS),
                                       capacity=CAPACITY)
    drops = jsim.simulate_frame(jax.random.PRNGKey(100), cfg, FALLRATE, 5.0)
    assert int(np.asarray(drops.valid).sum()) > 2500
    return tmp, bg.astype(np.float32) / 255.0, depth, drops


def _eager(fn):
    """``fn`` evaluated eagerly even inside a jitted caller (its
    arguments are static shapes)."""
    def eager(*args, **kw):
        with jax.ensure_compile_time_eval():
            return fn(*args, **kw)
    return eager


def _jax_colours(cfg, bg, depth, drops):
    st = cfg.settings
    _, env_photo, _ = jframe.frame_background(bg, depth, cfg)
    env = jph.env_features(env_photo,
                           downsample=jframe.env_downsamples(cfg)[1])
    return jph.drop_colors((drops.wp1 + drops.wp2) / 2.0, env,
                           sphere_radius=st.sphere_radius,
                           fov_deg=st.drop_fov_deg,
                           irrad_type=st.irrad_type), env.dirs


def _off(a, b, valid):
    """Each drop's largest colour difference relative to its colour."""
    d = np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), 1e-9)
    return np.where(valid, d, 0.0)


def test_jitted_direction_map_moves_cone_edge_drops(scene, monkeypatch):
    _, bg, depth, drops = scene
    st = jcam.settings_from_dict(SETTINGS)
    jcfg = jframe.PipelineConfig.build(st, (H, W), FALLRATE,
                                       drop_capacity=CAPACITY,
                                       cone_downsample=4)
    args = (jnp.asarray(bg), jnp.asarray(depth), drops)
    jit_c, jit_dirs = jax.jit(lambda *a: _jax_colours(jcfg, *a))(*args)
    eager_c, eager_dirs = _jax_colours(jcfg, *args)

    tst = tcam.settings_from_dict(SETTINGS)
    tcfg = tframe.PipelineConfig.build(tst, (H, W), FALLRATE,
                                       drop_capacity=CAPACITY,
                                       cone_downsample=4)
    tdrops = interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                           device="cpu")
    _, env_photo, _ = tframe.frame_background(
        torch.as_tensor(bg)[None], torch.as_tensor(depth)[None], tcfg)
    env = tph.env_features(env_photo,
                           downsample=tframe.env_downsamples(tcfg)[1])
    mid = (tdrops.wp1 + tdrops.wp2) / 2.0
    port_c = tph.drop_colors(mid[None], env, sphere_radius=tst.sphere_radius,
                             fov_deg=tst.drop_fov_deg,
                             irrad_type=tst.irrad_type)[0].numpy()

    valid = np.asarray(drops.valid)
    print(f"directions: jitted against eager max "
          f"{np.abs(np.asarray(jit_dirs) - np.asarray(eager_dirs)).max():.3g},"
          f" the port's against eager "
          f"{np.abs(env.dirs.numpy() - np.asarray(eager_dirs)).max():.3g}")
    np.testing.assert_allclose(env.dirs.numpy(), np.asarray(eager_dirs),
                               atol=2e-7, rtol=0)
    assert _off(port_c, np.asarray(eager_c), valid).max() < COLOUR_RTOL
    moved = np.nonzero(_off(np.asarray(jit_c), np.asarray(eager_c), valid)
                       > COLOUR_RTOL)[0]
    print(f"colours of {int(valid.sum())} drops: the port's against "
          f"raintpu's eager ones max "
          f"{_off(port_c, np.asarray(eager_c), valid).max():.3g}; the "
          f"jitted ones move drops {moved.tolist()} by "
          f"{_off(np.asarray(jit_c), np.asarray(eager_c), valid)[moved]}")
    assert 0 < len(moved) <= 4, moved
    np.testing.assert_array_equal(
        np.nonzero(_off(port_c, np.asarray(jit_c), valid) > COLOUR_RTOL)[0],
        moved)
    # Each moved drop has a texel within float rounding of its cone's
    # edge (the cone test of ops/photometry._cone_sums, in float64).
    p = tph.swap_yz(mid.double()).numpy()[moved]
    dirs = env.dirs.double().numpy()
    cos_t = np.cos(np.deg2rad(st.drop_fov_deg / 2.0))
    r = st.sphere_radius
    for pi in p:
        n = pi / np.linalg.norm(pi)
        s = r * dirs @ n - pi @ n
        w2 = r * r - 2.0 * r * dirs @ pi + pi @ pi
        edge = np.abs(s * s - cos_t * cos_t * w2) / (s * s)
        print(f"a texel at {edge[s >= 0].min():.3g} (relative) of the edge")
        assert (edge[s >= 0] < 1e-5).any()
    # The direction map alone moves them: with it evaluated eagerly the
    # jitted colours are the eager ones.
    monkeypatch.setattr(jph, "pixel_directions",
                        _eager(jph.pixel_directions))
    fixed_c, _ = jax.jit(lambda *a: _jax_colours(jcfg, *a))(*args)
    jax.clear_caches()
    assert _off(np.asarray(fixed_c), np.asarray(eager_c),
                valid).max() < COLOUR_RTOL


def _spec(mod, tmp, out):
    kw = dict(
        dataset="toy", sequences=["seqA"],
        images={"seqA": os.path.join(tmp, "seqA", "rgb")},
        depth={"seqA": os.path.join(tmp, "seqA", "depth")},
        calib={"seqA": None}, particles={"seqA": [None]},
        weather=[{"weather": "rain", "fallrate": int(FALLRATE)}],
        settings=SETTINGS, output_root=os.path.join(tmp, out),
        conflict_strategy="overwrite", batch_size=1,
        drop_capacity=CAPACITY, seed=3, save_format="npy",
        save_saturation=True, save_envmap=True, verbose=False)
    if mod is tpipe:
        kw["device"] = "cpu"
    return mod.JobSpec(**kw)


def _worst(name, got, want, bar=2e-4):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    print(f"{name}: max {d.max():.3g}, {int((d > bar).sum())} values over "
          f"{bar:g} ({(d > bar).mean():.3g} of them)")
    return d


def test_job_matches_raintpu_with_its_eager_maps(scene, monkeypatch):
    """The port's job against raintpu's twice: as raintpu runs (its
    saturation mask off the bar by the two moved colours), then with its
    maps taken from eager evaluation (within the bars but for the rain
    mask's cutoff flips)."""
    tmp, _, _, drops = scene
    j_out, t_out = [], []
    _recording(monkeypatch, jpipe, j_out)
    _recording(monkeypatch, tpipe, t_out)
    JaxJob, PortJob = _jobs({0: interop.numpy_fields(drops)})
    got = PortJob(_spec(tpipe, tmp, "port")).run()
    as_is = JaxJob(_spec(jpipe, tmp, "jax")).run()

    # The jitted render is traced anew with the maps evaluated eagerly.
    jax.clear_caches()
    monkeypatch.setattr(jph, "pixel_directions",
                        _eager(jph.pixel_directions))
    source = _eager(jenv._source_indices)

    def central(geom, dtype=jnp.float32):
        r, c, covered = source(geom, dtype)
        b, wc = geom.border, geom.cyl_width
        return r[:, b:b + wc], c[0, b:b + wc], covered[:, b:b + wc]

    monkeypatch.setattr(jenv, "_source_indices", source)
    monkeypatch.setattr(jenv, "_central_source_indices", central)
    want = JaxJob(_spec(jpipe, tmp, "jax_eager")).run()
    # No later test may meet the patched traces.
    jax.clear_caches()

    for stats in (as_is, want):
        for key in ("rendered", "skipped", "overflowed_drops"):
            assert got[key] == stats[key], key
    assert got["rendered"] == 1 and got["overflowed_drops"] == 0
    assert len(t_out) == 1 and len(j_out) == 2
    t, j, e = (types.SimpleNamespace(**o) for o in (t_out[0], *j_out))
    names = ("rain_mask", "rainy_image", "saturation_mask", "envmap")
    print(f"{int(np.asarray(drops.valid).sum())} valid drops; the port "
          "against raintpu as it runs:")
    off = {n: _worst(n, getattr(t, n), getattr(j, n)) for n in names}
    assert (off["saturation_mask"] > 2e-4).any()
    print("against raintpu with its maps made eagerly:")
    for n in names:
        _worst(n, getattr(t, n), getattr(e, n))
    assert_render_close(t, e, ("rainy_image", "saturation_mask"))
    np.testing.assert_allclose(t.envmap, e.envmap, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.overflow, e.overflow)
    assert float(t.rain_mask.sum()) > 100.0
