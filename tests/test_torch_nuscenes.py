"""The port's nuScenes path against raintpu's, on a miniature dataset.

The tree (``tests/torch_nuscenes_tree.py``: the one of
``tests/test_nuscenes.py`` with three ``.npy`` camera frames and a
denser LiDAR sweep per frame) goes through both packages. Exactly
equal: scene tokens, frame paths, camera settings, ego speeds, scene
durations, the LiDAR projection (uv and depth), ``dense_depth_map``
(raintpu's cv2 min filter against the port's max-pool, the numpy
z-buffer against ``scatter_reduce``), both plugins' ``resolve_paths``
and ``settings()`` (the GAN renaming and depth names included), the
CLI's resolution of the dataset, and the depth tool's files.

The slice as a whole: both packages' online render jobs on the tree,
through their CLIs' nuScenes path resolution, with the plugin's
settings cut to 160x90 (``cam_WH`` and ``cam_CCD_WH``), frames and
depth written at that size, the same drops and texture picks fed to
both sides (as ``tests/test_torch_pipeline.py`` does) and the fitted
ladder. Bars: the render bar — rain and saturation masks within atol
2e-4, rainy uint8 within 1 level; the counts equal.
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu import cli as jcli
from raintpu.data import nuscenes_data as jnd
from raintpu.data.datasets import nuscenes as jplug
from raintpu.data.datasets import nuscenes_gan as jgan
from raintpu.ops import rasterize as jrz
from raintpu.particles import schema as jschema
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.render import online as jonline
from raintpu.render import pipeline as jpipe
from raintpu.tools import nuscenes_depth as jdepth
from raintpu_torch import cli as tcli
from raintpu_torch import interop
from raintpu_torch.data import nuscenes_data as tnd
from raintpu_torch.data.datasets import nuscenes as tplug
from raintpu_torch.data.datasets import nuscenes_gan as tgan
from raintpu_torch.render import online as tonline
from raintpu_torch.render import pipeline as tpipe
from raintpu_torch.tools import nuscenes_depth as tdepth
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_nuscenes_tree import frame_name, write_tree

N_FRAMES = 3
H, W = 90, 160
CAP = 512
SEED = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """ROOT/source/nuscenes (the tables and 160x90 frames) and
    ROOT/depth/nuscenes (160x90 depth .npy per frame)."""
    root = str(tmp_path_factory.mktemp("torch_nusc"))
    data = write_tree(os.path.join(root, "source", "nuscenes"), N_FRAMES,
                      (H, W))
    rng = np.random.RandomState(2)
    dep = os.path.join(root, "depth", "nuscenes")
    os.makedirs(dep)
    for i in range(N_FRAMES):
        np.save(os.path.join(dep, frame_name(i) + ".npy"),
                (rng.rand(H, W) * 57 + 3).astype(np.float32))
    return root, data


@pytest.fixture
def fresh_plugins(monkeypatch):
    """Both packages' plugin caches empty for this test."""
    monkeypatch.setattr(jplug, "_dataset", None)
    monkeypatch.setattr(jgan, "_dataset", None)
    monkeypatch.setattr(tplug, "_datasets", {})
    monkeypatch.setattr(tgan, "_datasets", {})


def test_quat_rotmat_equal():
    rng = np.random.RandomState(0)
    for q in [[1, 0, 0, 0], [0, 0, 0, 0]] + list(rng.randn(5, 4)):
        np.testing.assert_array_equal(tnd.quat_rotmat(q), jnd.quat_rotmat(q))


@pytest.mark.parametrize("kw", [{}, {"only_annotated": True},
                                {"specific_tokens": ["sd_cam0",
                                                     "sd_cam2"]}])
def test_scene_access_equal(tree, kw):
    _, data = tree
    j, t = jnd.NuScenesCameraData(data, **kw), tnd.NuScenesCameraData(
        data, **kw)
    assert t.tokens == j.tokens
    assert t.scene_tokens == j.scene_tokens == ["scene0"]
    assert t.get_filepaths("scene0") == j.get_filepaths("scene0")
    assert t.camera_settings("scene0") == j.camera_settings("scene0")
    assert t.camera_motions("scene0") == j.camera_motions("scene0")
    assert t.scene_duration("scene0") == j.scene_duration("scene0")
    jg = jnd.NuScenesGANCameraData(data, gan_root="/gan", post_fix="fake_B",
                                   **kw)
    tg = tnd.NuScenesGANCameraData(data, gan_root="/gan", post_fix="fake_B",
                                   **kw)
    assert tg.get_filepaths("scene0") == jg.get_filepaths("scene0")


def test_lidar_projection_equal(tree):
    _, data = tree
    j, t = jnd.NuScenesCameraData(data), tnd.NuScenesCameraData(data)
    for i in range(N_FRAMES):
        juv, jdep = j.project_lidar_depth(f"sd_cam{i}")
        tuv, tdep = t.project_lidar_depth(f"sd_cam{i}")
        assert len(jdep) > 1000
        np.testing.assert_array_equal(tuv, juv)
        np.testing.assert_array_equal(tdep, jdep)


@pytest.mark.parametrize("dilate", [3, 1, 5])
def test_dense_depth_map_equal(tree, dilate):
    _, data = tree
    j, t = jnd.NuScenesCameraData(data), tnd.NuScenesCameraData(data)
    uv, _ = j.project_lidar_depth("sd_cam1")
    pix = uv.astype(int)
    hit_twice = len(pix) - len(np.unique(pix[:, 1] * 1600 + pix[:, 0]))
    assert hit_twice > 100, "the z-buffer must see shared pixels"
    want = j.dense_depth_map("sd_cam1", dilate=dilate)
    got = t.dense_depth_map("sd_cam1", dilate=dilate, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == tnd.FAR_PLANE_M).any() and (want < 60).any()


def _params(data, depth_root, **kw):
    base = dict(dataset_root=data, depth_root=depth_root, sequences="",
                json_file=None, gan_root="/gan", post_fix="fake_B")
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("plugin", ["nuscenes", "nuscenes_gan"])
@pytest.mark.parametrize("case", ["all", "index", "token", "split",
                                  "no_postfix"])
def test_plugins_equal(tree, tmp_path, fresh_plugins, plugin, case):
    root, data = tree
    kw = {"index": {"sequences": "0"}, "token": {"sequences": "scene0"},
          "no_postfix": {"post_fix": ""}}.get(case, {})
    if case == "split":
        split = str(tmp_path / "split.json")
        with open(split, "w") as fh:
            fh.write('{"sample_data_tokens": ["sd_cam0", "sd_cam2"]}')
        kw = {"json_file": split}
    jmod, tmod = {"nuscenes": (jplug, tplug),
                  "nuscenes_gan": (jgan, tgan)}[plugin]
    depth_root = os.path.join(root, "depth", "nuscenes")
    want = jmod.resolve_paths(_params(data, depth_root, **kw))
    got = tmod.resolve_paths(_params(data, depth_root, **kw))
    for attr in ("sequences", "images", "depth", "calib"):
        assert getattr(got, attr) == getattr(want, attr), attr
    n = 2 if case == "split" else N_FRAMES
    assert len(got.images["scene0"]) == n
    assert tmod.settings() == jmod.settings()


def test_plugin_tables_are_kept_per_root(tree, tmp_path, fresh_plugins):
    """A second dataset root in the same process gets its own tables
    (raintpu's plugin keeps the first root's)."""
    root, data = tree
    other = str(tmp_path / "other")
    shutil.copytree(data, other)
    depth_root = os.path.join(root, "depth", "nuscenes")
    first = tplug.resolve_paths(_params(data, depth_root))
    second = tplug.resolve_paths(_params(other, depth_root))
    assert first.images["scene0"][0].startswith(data)
    assert second.images["scene0"][0].startswith(other)
    assert len(tplug._datasets) == 2
    gan = tgan.resolve_paths(_params(other, depth_root, gan_root="/g2"))
    assert gan.images["scene0"][0].startswith("/g2")


def test_depth_tool_files_equal(tree, tmp_path, capsys):
    _, data = tree
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jdepth.process(data, jout) == N_FRAMES
    assert tdepth.process(data, tout, device="cpu") == N_FRAMES
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) == [
        frame_name(i) + ".npy" for i in range(N_FRAMES)]
    for n in names:
        a, b = np.load(os.path.join(jout, n)), np.load(os.path.join(tout, n))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    # Existing maps are kept; the CLI entry takes --device.
    assert tdepth.main([data, tout, "--device", "cpu"]) == 0
    assert "Wrote 0 depth maps" in capsys.readouterr().out


def _frame_drops(settings):
    """One numpy DropBatch per frame from raintpu's simulator at the
    cut camera, 100 mm/hr."""
    rs = jcam.settings_from_dict(settings)
    cfg = jsim.SimConfig.from_settings(rs, capacity=CAP)
    out = {}
    for i in range(N_FRAMES):
        d = jsim.simulate_frame(jax.random.PRNGKey(40 + i), cfg, 100.0, 8.0)
        out[i] = interop.numpy_fields(d)
    return out


def _stack(drops, fidx):
    return {k: np.stack([drops[i][k] for i in fidx]) for k in drops[0]}


def _jax_batch(st):
    return jschema.DropBatch(**{k: jnp.asarray(v) for k, v in st.items()})


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


def _recording(monkeypatch, mod, sink):
    real = mod.render_frames

    def record(*args, **kw):
        out = real(*args, **kw)
        sink.append({k: None if v is None else np.asarray(v)
                     for k, v in vars(out).items()})
        return out

    monkeypatch.setattr(mod, "render_frames", record)


def test_nuscenes_online_job_matches_raintpu(tree, fresh_plugins,
                                             monkeypatch):
    root, _ = tree
    argv = ["--dataset", "nuscenes", "-k", os.path.join(root, "source"),
            "-d", os.path.join(root, "depth"), "--online",
            "--intensity", "100", "--noverbose"]
    jns = jcli.check_args(argv)
    tns = tcli.check_args(argv + ["--device", "cpu"])
    assert tns.sequences == jns.sequences == ["scene0"]
    for attr in ("images", "depth", "calib", "settings", "weather"):
        assert getattr(tns, attr) == getattr(jns, attr), attr
    assert tns.settings["cam_exposure"] == 20.0
    assert tns.settings["cam_f_number"] == 1.8

    settings = {**tns.settings, "cam_WH": [W, H], "cam_CCD_WH": [W, H]}
    drops = _frame_drops(settings)

    class JaxJob(jonline.OnlineRenderJob):
        def _drops_for_frames(self, fidx):
            return _jax_batch(_stack(drops, fidx))

    class PortJob(tonline.OnlineRenderJob):
        def _drops_for_frames(self, fidx):
            return interop.drop_batch_from_numpy(_stack(drops, fidx),
                                                 device=self.device)

        _frame_draws = _jax_draws

    def spec(mod, out, **kw):
        return mod.JobSpec(
            dataset="nuscenes", sequences=tns.sequences, images=tns.images,
            depth=tns.depth, calib=tns.calib, particles=tns.particles,
            weather=tns.weather, settings=settings,
            output_root=os.path.join(root, out),
            conflict_strategy="overwrite", batch_size=2, drop_capacity=CAP,
            seed=SEED, save_format="npy", save_saturation=True,
            save_envmap=True, raster_profile="fitted", verbose=False, **kw)

    j_out, t_out = [], []
    _recording(monkeypatch, jpipe, j_out)
    _recording(monkeypatch, tpipe, t_out)
    want = JaxJob(spec(jpipe, "jax_out")).run()
    got = PortJob(spec(tpipe, "port_out", device="cpu")).run()
    for key in ("rendered", "skipped", "overflowed_drops"):
        assert got[key] == want[key], key
    assert got["rendered"] == N_FRAMES and got["overflowed_drops"] == 0

    assert len(j_out) == len(t_out) == 2
    mass = 0.0
    for j, t in zip(j_out, t_out):
        assert t["rain_mask"].shape == (2, H, W)
        np.testing.assert_allclose(t["rain_mask"], j["rain_mask"],
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["saturation_mask"],
                                   j["saturation_mask"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(t["envmap"], j["envmap"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(t["overflow"], j["overflow"])
        mass += float(t["rain_mask"].sum())
    assert mass > 1.0, "the frames must render rain"

    rain = os.path.join("nuscenes", "scene0", "rain", "100mm")
    for sub in ("rainy_image", "rain_mask", "saturation_mask"):
        jd = os.path.join(root, "jax_out", rain, sub)
        td = os.path.join(root, "port_out", rain, sub)
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(td)) == [
            frame_name(i) + ".npy" for i in range(N_FRAMES)]
        for n in names:
            a, b = np.load(os.path.join(jd, n)), np.load(os.path.join(td, n))
            assert a.dtype == b.dtype and a.shape == b.shape
            tol = 2e-4 if sub == "rain_mask" else 1
            assert np.abs(a.astype(np.float64) - b).max() <= tol, (sub, n)
