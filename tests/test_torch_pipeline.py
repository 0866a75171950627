"""The port's render job against raintpu's, on a tiny on-disk dataset.

Both jobs render the same three 48x96 frames of a customdb-style
dataset (``.npy`` frames, so no image codec is involved) with the
'tiny' and the 'default' raster profiles, saving npy outputs with the
saturation mask and the envmap. Each job is subclassed to take the same
numpy DropBatch per frame, and the port's job takes raintpu's per-frame
texture picks (``PRNGKey(seed * 100003 + i)``) as data. Bars: rainy
uint8 within 1 level; rain and saturation masks within atol 2e-4 (the
fused path's bar against the XLA path that raintpu runs on the CPU);
envmaps within 1e-5; the rendered/skipped/overflow counts equal.

The offline jobs of both packages render the same particle XML file
(written by the port's simulation tool), with the 'default' and the
'fitted' ladder, to the same bars, with equal truncation and overflow
counts.

Then the port alone: the skip strategy resumes, a frame's output does
not depend on ``frame_start``, frame i's texture picks and streak noise
do not depend on its batch, a pano job reads the panoramas named like
its frames, the online job's batched simulation equals its one-frame
simulation, and truncation is counted exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.ops import rasterize as jrz
from raintpu.particles import schema as jschema
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.render import pipeline as jpipe
from raintpu_torch import interop
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import online as tonline
from raintpu_torch.render import pipeline as tpipe
from raintpu_torch.tools import particles_simulation as ttool
from torch_cpu_threads import one_torch_thread  # noqa: F401

H, W, N_FRAMES, CAP = 48, 96, 3, 64
SEED = 3
SETTINGS = {
    "cam_hz": 10, "cam_CCD_WH": [W, H], "cam_CCD_pixsize": 20.0,
    "cam_WH": [W, H], "cam_focal": 8, "cam_gain": 20,
    "cam_f_number": 6.0, "cam_focus_plane": 6.0, "cam_exposure": 2,
    "cam_pos": [1.5, 1.5, 0.3], "cam_lookat": [1.5, 1.5, -1.0],
    "cam_up": [0.0, 1.0, 0.0], "depth_scale": 1, "render_scale": 1,
    "sim_mode": "normal", "sim_duration": 0.5, "sim_steps": {},
    "sim_hz": 2000, "sequences": {},
}


def _make_dataset(root):
    rng = np.random.RandomState(1)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, "seqA", sub))
    for i in range(N_FRAMES):
        np.save(os.path.join(root, "seqA", "rgb", f"{i:06d}.npy"),
                (rng.rand(H, W, 3) * 255).astype(np.uint8))
        np.save(os.path.join(root, "seqA", "depth", f"{i:06d}.npy"),
                (rng.rand(H, W) * 60 + 3).astype(np.float32))


def _frame_drops():
    """One numpy DropBatch per frame; near drops (z <= 3 m) so that the
    default ladder's big rungs get some."""
    settings = jcam.settings_from_dict(SETTINGS)
    cfg = jsim.SimConfig.from_settings(settings, capacity=CAP)
    cfg = jsim.SimConfig(**{**cfg.__dict__, "z_max": 3.0})
    out = {}
    for i in range(N_FRAMES):
        d = jsim.simulate_frame(jax.random.PRNGKey(100 + i), cfg, 25.0, 5.0)
        out[i] = interop.numpy_fields(d)
    return out


def _stack(drops, fidx):
    return {k: np.stack([drops[i][k] for i in fidx]) for k in drops[0]}


def _spec(mod, tmp, out, **kw):
    base = dict(
        dataset="toy", sequences=["seqA"],
        images={"seqA": os.path.join(tmp, "seqA", "rgb")},
        depth={"seqA": os.path.join(tmp, "seqA", "depth")},
        calib={"seqA": None}, particles={"seqA": [None]},
        weather=[{"weather": "rain", "fallrate": 25}], settings=SETTINGS,
        output_root=os.path.join(tmp, out), conflict_strategy="overwrite",
        batch_size=2, drop_capacity=CAP, seed=SEED, save_format="npy",
        save_saturation=True, save_envmap=True, verbose=False)
    base.update(kw)
    if mod is tpipe:
        base.setdefault("device", "cpu")
    return mod.JobSpec(**base)


def _jobs(drops):
    """raintpu's and the port's RenderJob on the given per-frame drops
    (the port's with raintpu's texture picks)."""

    class JaxJob(jpipe.RenderJob):
        def _setup_drop_source(self, seq, w_i, weather, hw):
            pass

        def _drops_for_frames(self, fidx):
            return _jax_batch(_stack(drops, fidx))

    class PortJob(tpipe.RenderJob):
        def _setup_drop_source(self, seq, w_i, weather, hw):
            pass

        def _drops_for_frames(self, fidx):
            return interop.drop_batch_from_numpy(_stack(drops, fidx),
                                                 device=self.device)

        _frame_draws = _jax_draws

    return JaxJob, PortJob


def _jax_draws(job, t_drops, edges, fidx):
    """raintpu's texture picks for these frames (PRNGKey(seed * 100003 +
    i), split, per-drop keys), as data; no streak noise."""
    st = _jax_batch(interop.numpy_fields(t_drops))
    jedges = jnp.asarray(edges.numpy())
    keys = jnp.stack([jax.random.PRNGKey(job.spec.seed * 100003 + i)
                      for i in fidx])
    picks = jax.vmap(lambda d, k: jrz.select_textures(
        d, jedges, jax.random.split(k)[0]))(st, keys)
    return torch.as_tensor(np.array(picks)), None


def _jax_batch(st):
    return jschema.DropBatch(**{k: jnp.asarray(v) for k, v in st.items()})


def _recording(monkeypatch, mod, sink):
    real = mod.render_frames

    def record(*args, **kw):
        out = real(*args, **kw)
        sink.append({k: None if v is None else np.asarray(v)
                     for k, v in vars(out).items()})
        return out

    monkeypatch.setattr(mod, "render_frames", record)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_pipe"))
    _make_dataset(tmp)
    return tmp, _frame_drops()


def _out_dir(tmp, out):
    return os.path.join(tmp, out, "toy", "seqA", "rain", "25mm")


@pytest.mark.parametrize("profile", ["tiny", "default"])
def test_job_matches_raintpu(dataset, monkeypatch, profile):
    tmp, drops = dataset
    j_out, t_out = [], []
    _recording(monkeypatch, jpipe, j_out)
    _recording(monkeypatch, tpipe, t_out)
    JaxJob, PortJob = _jobs(drops)
    want = JaxJob(_spec(jpipe, tmp, f"jax_{profile}",
                        raster_profile=profile)).run()
    got = PortJob(_spec(tpipe, tmp, f"port_{profile}",
                        raster_profile=profile)).run()
    for key in ("rendered", "skipped", "overflowed_drops"):
        assert got[key] == want[key], key
    assert got["rendered"] == N_FRAMES

    assert len(j_out) == len(t_out) == 2
    mass = 0.0
    for j, t in zip(j_out, t_out):
        np.testing.assert_allclose(t["rain_mask"], j["rain_mask"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["saturation_mask"],
                                   j["saturation_mask"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["envmap"], j["envmap"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(t["overflow"], j["overflow"])
        mass += float(t["rain_mask"].sum())
    assert mass > 1.0, "the frames must render rain"

    jd, td = _out_dir(tmp, f"jax_{profile}"), _out_dir(tmp, f"port_{profile}")
    for sub in ("rainy_image", "rain_mask", "saturation_mask"):
        names = sorted(os.listdir(os.path.join(jd, sub)))
        assert names == sorted(os.listdir(os.path.join(td, sub)))
        assert names == [f"{i:06d}.npy" for i in range(N_FRAMES)]
        for n in names:
            a = np.load(os.path.join(jd, sub, n))
            b = np.load(os.path.join(td, sub, n))
            assert a.dtype == b.dtype and a.shape == b.shape
            tol = 2e-4 if sub == "rain_mask" else 1
            assert np.abs(a.astype(np.float64) - b).max() <= tol, (sub, n)
    envs = os.path.join(tmp, f"port_{profile}", "toy", "seqA", "envmap")
    assert sorted(os.listdir(envs)) == [f"{i:06d}.npy"
                                        for i in range(N_FRAMES)]


def test_port_job_resumes_and_keys_frames(dataset):
    tmp, drops = dataset
    _, PortJob = _jobs(drops)
    full = PortJob(_spec(tpipe, tmp, "port_keys")).run()
    assert full["rendered"] == N_FRAMES
    # The host's median ms a batch in each stage of the render.
    assert list(full["stage_ms"]) == list(tpipe.STAGES)
    assert all(ms > 0 for ms in full["stage_ms"].values())
    again = PortJob(_spec(tpipe, tmp, "port_keys",
                          conflict_strategy="skip")).run()
    assert again["rendered"] == 0 and again["skipped"] == N_FRAMES
    assert again["stage_ms"] == {}
    one = PortJob(_spec(tpipe, tmp, "port_window", frame_start=1,
                        frame_end=2)).run()
    assert one["rendered"] == 1
    a = np.load(os.path.join(_out_dir(tmp, "port_keys"), "rainy_image",
                             "000001.npy"))
    b = np.load(os.path.join(_out_dir(tmp, "port_window"), "rainy_image",
                             "000001.npy"))
    np.testing.assert_array_equal(a, b)


def test_port_texture_picks_are_keyed_by_frame(dataset):
    """Without picks given as data, frame i's picks come from its own
    generator: the same in any batch."""
    tmp, drops = dataset
    job = tpipe.RenderJob(_spec(tpipe, tmp, "port_picks"))
    edges = torch.as_tensor(np.array([0.12, 0.24, 0.48, 0.96], np.float32))
    d = interop.drop_batch_from_numpy(_stack(drops, [0, 1, 2]),
                                      device="cpu")
    batch, noise = job._frame_draws(d, edges, [0, 1, 2])
    alone, _ = job._frame_draws(d.map(lambda t: t[1:2]), edges, [1])
    assert noise is None
    assert torch.equal(batch[1], alone[0])
    assert not torch.equal(batch[0], batch[1])


def test_port_noise_is_keyed_by_frame(dataset):
    """With streak noise, frame i draws its noise after its texture picks
    from the same generator: the same draws in any batch."""
    tmp, drops = dataset
    job = tpipe.RenderJob(_spec(tpipe, tmp, "port_noise", noise_scale=2.0,
                                noise_std=3.0))
    edges = torch.as_tensor(np.array([0.12, 0.24, 0.48, 0.96], np.float32))
    d = interop.drop_batch_from_numpy(_stack(drops, [0, 1, 2]),
                                      device="cpu")
    picks, noise = job._frame_draws(d, edges, [0, 1, 2])
    alone_picks, alone = job._frame_draws(
        d.map(lambda t: t[2:3]), edges, [2])
    assert torch.equal(noise[2], alone[0])
    assert torch.equal(picks[2], alone_picks[0])
    assert not torch.equal(noise[0], noise[1])
    gen = torch.Generator().manual_seed(SEED * 100003 + 1)
    trz_picks = torch.randint(0, 10, (CAP,), generator=gen)
    assert torch.equal(picks[1] % 10, trz_picks)
    want = torch.randn(CAP, generator=gen) * 6.0
    assert torch.equal(noise[1], want)


def _online(tmp, **kw):
    job = tonline.OnlineRenderJob(_spec(tpipe, tmp, "port_online", **kw))
    job._setup_drop_source("seqA", 0, {"weather": "rain", "fallrate": 25},
                           (H, W))
    return job


def test_online_batched_simulation_equals_one_frame(dataset):
    tmp, _ = dataset
    job = _online(tmp, drop_capacity=256)
    batched = job._simulate_batch([0, 1, 2])
    for b, i in enumerate([0, 1, 2]):
        one = job._drops_for_frame(i)
        for name, arr in vars(one).items():
            assert torch.equal(getattr(batched, name)[b], arr), (i, name)
    assert batched.count().sum() > 0
    # Compaction keeps every valid drop, in order.
    got = job._drops_for_frames([0, 1, 2])
    assert got.capacity == job._render_cap < batched.capacity
    for b in range(3):
        assert torch.equal(got.ip1[b][got.valid[b]],
                           batched.ip1[b][batched.valid[b]])


def test_online_truncation_is_counted_exactly(dataset):
    tmp, _ = dataset
    job = _online(tmp, drop_capacity=2,
                  weather=[{"weather": "rain", "fallrate": 100}])
    job._setup_drop_source("seqA", 0, {"weather": "rain", "fallrate": 100},
                           (H, W))
    job._simulate_batch([0, 1, 1])
    cfg = job._sim_cfg
    want = 0
    for i in (0, 1):
        lam = tsim.expected_drop_count(cfg, 100.0)
        assert lam > 2
        want += int(tsim.truncated_count(
            tsim.frame_generator(SEED, i, "cpu"), cfg,
            torch.tensor([100.0]))[0])
    assert job._truncated_total == want > 0
    stats = tonline.OnlineRenderJob(_spec(
        tpipe, tmp, "port_trunc", drop_capacity=2, raster_profile="tiny",
        weather=[{"weather": "rain", "fallrate": 100}])).run()
    assert stats["truncated_drops"] > 0 and stats["rendered"] == N_FRAMES


@pytest.fixture(scope="module")
def particles(dataset):
    """The port's tool's XML for the dataset's weather (CPU), 5 frames at
    200 mm/hr: 6-18 drops a frame, more than the jobs' capacity in
    some."""
    tmp, _ = dataset
    out = os.path.join(tmp, "particles", "toy", "seqA", "rain", "200mm")
    return ttool.simulate_to_xml(out, SETTINGS,
                                 {"weather": "rain", "fallrate": 200},
                                 capacity=256, seed=2, verbose=False,
                                 device="cpu")


@pytest.mark.parametrize("profile", ["default", "fitted"])
def test_offline_job_matches_raintpu(dataset, particles, monkeypatch,
                                     profile):
    """Both packages' RenderJob on the same XML file (the offline mode):
    the port's packs each batch on the host, and with 'fitted' both fit
    the same ladder to the first frames' drops."""
    tmp, _ = dataset
    j_out, t_out = [], []
    _recording(monkeypatch, jpipe, j_out)
    _recording(monkeypatch, tpipe, t_out)

    class PortJob(tpipe.RenderJob):
        _frame_draws = _jax_draws

    kw = dict(particles={"seqA": [particles]}, raster_profile=profile,
              drop_capacity=10,
              weather=[{"weather": "rain", "fallrate": 200}])
    want = jpipe.RenderJob(_spec(jpipe, tmp, f"jax_xml_{profile}",
                                 **kw)).run()
    got = PortJob(_spec(tpipe, tmp, f"port_xml_{profile}", **kw)).run()
    for key in ("rendered", "skipped", "overflowed_drops",
                "truncated_drops"):
        assert got[key] == want[key], key
    assert got["rendered"] == N_FRAMES and got["truncated_drops"] > 0
    assert len(j_out) == len(t_out) == 2
    mass = 0.0
    for j, t in zip(j_out, t_out):
        np.testing.assert_allclose(t["rain_mask"], j["rain_mask"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["saturation_mask"],
                                   j["saturation_mask"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["envmap"], j["envmap"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(t["overflow"], j["overflow"])
        mass += float(t["rain_mask"].sum())
    assert mass > 1.0, "the frames must render rain"
    jd = os.path.join(tmp, f"jax_xml_{profile}", "toy", "seqA", "rain",
                      "200mm", "rainy_image")
    td = jd.replace("jax_xml", "port_xml")
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for n in os.listdir(jd):
        a, b = np.load(os.path.join(jd, n)), np.load(os.path.join(td, n))
        assert np.abs(a.astype(np.int16) - b).max() <= 1, n


def test_pano_job(tmp_path):
    """env_type='pano': each frame's envmap is the 32x64 panorama named
    like its frame file (PNG frames here, read with PIL), and the drops'
    photometry follows it."""
    rng = np.random.RandomState(4)
    names = [f"{i:06d}.png" for i in range(2)]
    from PIL import Image
    for sub in ("rgb", "depth", "panos"):
        (tmp_path / sub).mkdir()
    for n in names:
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            tmp_path / "rgb" / n)
        Image.fromarray(((rng.rand(H, W) * 60 + 3) * 256).astype(
            np.uint16)).save(tmp_path / "depth" / n)
        pano = np.zeros((32, 64, 3), np.uint8)
        pano[..., 0] = 255
        pano[..., 1] = (rng.rand(32, 64) * 40).astype(np.uint8)
        Image.fromarray(pano).save(tmp_path / "panos" / n)
    _, PortJob = _jobs(_frame_drops())
    kw = dict(images={"seqA": str(tmp_path / "rgb")},
              depth={"seqA": str(tmp_path / "depth")},
              raster_profile="tiny")
    outs = {}
    for env in ("ours", "pano"):
        stats = PortJob(_spec(tpipe, str(tmp_path), f"out_{env}",
                              env_type=env, panos_dir=str(tmp_path / "panos"),
                              **kw)).run()
        assert stats["rendered"] == 2
        outs[env] = os.path.join(str(tmp_path), f"out_{env}", "toy", "seqA")
    n = names[1].replace(".png", ".npy")
    env = np.load(os.path.join(outs["pano"], "envmap", n))
    want = np.asarray(Image.open(tmp_path / "panos" / names[1]))
    assert np.array_equal(env, want)
    a, b = (np.load(os.path.join(outs[e], "rain", "25mm", "rainy_image", n))
            for e in ("pano", "ours"))
    assert np.abs(a.astype(np.float64) - b).mean() > 0.01
    with pytest.raises(ValueError, match="panos_dir"):
        PortJob(_spec(tpipe, str(tmp_path), "out_nodir", env_type="pano",
                      **kw)).run()


def test_png_outputs_match_raintpu(dataset):
    """--save_format png (the CLI's default): the same files as raintpu's
    job writes; rainy PNGs, saturation PNGs, envmaps and the 16-bit
    ``_raw`` mask companions within 1 level; the colormapped masks of
    the same size."""
    from PIL import Image

    tmp, drops = dataset
    JaxJob, PortJob = _jobs(drops)
    kw = dict(raster_profile="tiny", save_format="png")
    want = JaxJob(_spec(jpipe, tmp, "jax_png", **kw)).run()
    got = PortJob(_spec(tpipe, tmp, "port_png", **kw)).run()
    assert got["rendered"] == want["rendered"] == N_FRAMES
    jroot = os.path.join(tmp, "jax_png", "toy", "seqA")
    troot = os.path.join(tmp, "port_png", "toy", "seqA")
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jroot)
                    for d, _, fs in os.walk(jroot) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(d, f), troot)
                    for d, _, fs in os.walk(troot) for f in fs)
    assert tfiles == jfiles
    assert len(jfiles) == N_FRAMES * 5  # rainy, mask + raw, sat, envmap
    for rel in jfiles:
        a = np.asarray(Image.open(os.path.join(jroot, rel)))
        b = np.asarray(Image.open(os.path.join(troot, rel)))
        assert a.shape == b.shape and a.dtype == b.dtype, rel
        colormapped = "rain_mask" in rel and not rel.endswith("_raw.png")
        if not colormapped:
            assert np.abs(a.astype(np.int64) - b).max() <= 1, rel
    raw = np.asarray(Image.open(os.path.join(
        troot, "rain", "25mm", "rain_mask", "000001_raw.png")))
    assert raw.dtype == np.uint16 and raw.max() > 0


def test_rename_folder_keeps_the_first_outputs(dataset):
    """--conflict_strategy rename_folder: a second run into an existing
    weather folder writes to ``{N}mm_copy00000`` (then ``_copy00001``)
    and leaves the first run's outputs as they were."""
    tmp, drops = dataset
    _, PortJob = _jobs(drops)
    first = PortJob(_spec(tpipe, tmp, "port_rename",
                          raster_profile="tiny")).run()
    assert first["rendered"] == N_FRAMES
    rain = os.path.join(tmp, "port_rename", "toy", "seqA", "rain")
    before = np.load(os.path.join(rain, "25mm", "rainy_image", "000000.npy"))
    for copy in ("25mm_copy00000", "25mm_copy00001"):
        stats = PortJob(_spec(tpipe, tmp, "port_rename",
                              raster_profile="tiny",
                              conflict_strategy="rename_folder")).run()
        assert stats["rendered"] == N_FRAMES and stats["skipped"] == 0
        again = np.load(os.path.join(rain, copy, "rainy_image",
                                     "000000.npy"))
        np.testing.assert_array_equal(again, before)
    assert sorted(os.listdir(rain)) == ["25mm", "25mm_copy00000",
                                        "25mm_copy00001"]
    np.testing.assert_array_equal(
        np.load(os.path.join(rain, "25mm", "rainy_image", "000000.npy")),
        before)


def test_online_compaction_refits_on_overflow(dataset):
    """A batch with more valid drops than the fitted render capacity
    refits the capacity upward: every valid drop is rendered and none is
    counted truncated (raintpu's test_online_compaction_refits_on_
    overflow)."""
    tmp, _ = dataset
    job = _online(tmp, drop_capacity=512)
    raw = job._simulate_batch([0, 1, 2])
    n_valid = int(raw.count().max())
    assert n_valid >= 2
    job._render_cap = 1    # as if a lighter batch had fitted it
    before = job._truncated_total
    got = job._compact_for_render(raw)
    assert job._render_cap >= n_valid
    assert got.capacity == job._render_cap < raw.capacity
    assert torch.equal(got.count(), raw.count())
    for b in range(3):
        assert torch.equal(got.ip1[b][got.valid[b]], raw.ip1[b][raw.valid[b]])
    assert job._truncated_total == before
    # A batch within the fitted capacity keeps it.
    cap = job._render_cap
    job._compact_for_render(raw)
    assert job._render_cap == cap
