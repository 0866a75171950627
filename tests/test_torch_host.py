"""The port's own copies of the JAX package's host code give the same
values: camera settings, the texture database and its factorization,
the simulation schedule, the dataset plugins and the frame loader."""

import dataclasses
import os

import numpy as np
import pytest

from raintpu.data import db as jdb
from raintpu.data import io as jio
from raintpu.data import textures as jtex
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.utils import logging as jlog
from raintpu_torch.data import db as tdb
from raintpu_torch.data import io as tio
from raintpu_torch.data import textures as ttex
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import camera as tcam
from raintpu_torch.utils import logging as tlog
from torch_cpu_threads import one_torch_thread  # noqa: F401

# The settings dict of tests/test_pipeline.py's jobs (48x96 frames).
SMALL = {
    "cam_hz": 10, "cam_CCD_WH": [96, 48], "cam_CCD_pixsize": 20.0,
    "cam_WH": [96, 48], "cam_focal": 8, "cam_gain": 20,
    "cam_f_number": 6.0, "cam_focus_plane": 6.0, "cam_exposure": 2,
    "cam_pos": [1.5, 1.5, 0.3], "cam_lookat": [1.5, 1.5, -1.0],
    "cam_up": [0.0, 1.0, 0.0], "depth_scale": 1, "render_scale": 1,
    "sim_mode": "normal", "sim_duration": 0.5, "sim_steps": {},
    "sim_hz": 2000, "sequences": {},
}


def _settings_dicts():
    small = SMALL
    steps = dict(small, sim_mode="steps",
                 sim_steps={"cam_motion": [100.0, 50.0, 0.0],
                            "rain_fallrate": [30, 20],
                            "cam_exposure": [1.0, 3.0, 4.0],
                            "cam_focal": [6.0, 8.0]})
    return {"kitti": {**jdb.default_settings(),
                      **jdb._load_plugin("kitti").settings()},
            "customdb": jdb.settings("customdb"),
            "test_pipeline": small, "steps": steps}


@pytest.mark.parametrize("name", ["kitti", "customdb", "test_pipeline",
                                  "steps"])
def test_settings_from_dict_match(name):
    d = _settings_dicts()[name]
    j, t = jcam.settings_from_dict(d), tcam.settings_from_dict(d)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for cls in ("CameraSettings", "RenderSettings", "SimSettings"):
        # Field names, types and defaults (a nested settings default by
        # its repr: the two packages' classes never compare equal).
        jf = [(f.name, f.type, repr(f.default)) for f in
              dataclasses.fields(getattr(jcam, cls))]
        tf = [(f.name, f.type, repr(f.default)) for f in
              dataclasses.fields(getattr(tcam, cls))]
        assert jf == tf, cls
    cam_j, cam_t = j.camera, t.camera
    for prop in ("exposure_s", "focal_m", "focal_px"):
        assert getattr(cam_j, prop) == getattr(cam_t, prop)


@pytest.mark.parametrize("name", ["kitti", "test_pipeline", "steps"])
@pytest.mark.parametrize("n_frames", [None, 5])
def test_schedule_matches_exactly(name, n_frames):
    d = _settings_dicts()[name]
    want = jsim.schedule_from_settings(jcam.settings_from_dict(d), 25.0,
                                       n_frames)
    got = tsim.schedule_from_settings(tcam.settings_from_dict(d), 25.0,
                                      n_frames)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 7])
def test_procedural_database_and_factors_match_exactly(seed):
    j = jtex.procedural_streak_database(seed=seed)
    t = ttex.procedural_streak_database(seed=seed)
    assert np.array_equal(j.textures, t.textures)
    assert np.array_equal(j.bin_edges, t.bin_edges)
    assert j.canvas == t.canvas and j.source == t.source
    for kw in (dict(), dict(rank=6, modes_y=32, modes_x=12)):
        for a, b in zip(jtex.factorize_streak_db(j, **kw),
                        ttex.factorize_streak_db(t, **kw)):
            assert np.array_equal(a, b)
    g = ttex.get_streak_database(None, None, seed=seed)
    assert np.array_equal(g.textures, t.textures)


def test_texture_bank_goes_to_the_device_asked():
    db = ttex.procedural_streak_database()
    bank = ttex.texture_bank(db, device="cpu")
    assert bank.raw.device.type == "cpu"
    ay, bx = ttex.factorize_streak_db(db, rank=6, modes_y=32, modes_x=12)
    assert np.array_equal(bank.ay.numpy(), ay)
    assert np.array_equal(bank.bx.numpy(), bx)


def test_plugins_and_loader_match(tmp_path):
    """customdb and kitti plugins resolve the same paths and settings;
    the frame loader reads .npy frames alike."""
    root = tmp_path / "customdb"
    rng = np.random.RandomState(0)
    for seq in ("seqB", "seqA"):
        for sub in ("rgb", "depth"):
            (root / seq / sub).mkdir(parents=True)
        for i in (10, 2):
            np.save(root / seq / "rgb" / f"{i}.npy",
                    (rng.rand(12, 20, 3) * 255).astype(np.uint8))
            np.save(root / seq / "depth" / f"{i}.npy",
                    (rng.rand(12, 20) * 50).astype(np.float32))

    def params():
        from types import SimpleNamespace
        return SimpleNamespace(images_root=str(root),
                               dataset_root=str(root))

    jp = jdb.resolve_paths("customdb", params())
    tp = tdb.resolve_paths("customdb", params())
    assert sorted(jp.sequences) == sorted(tp.sequences)
    for attr in ("images", "depth", "calib"):
        assert getattr(jp, attr) == getattr(tp, attr)
    assert jdb.settings("customdb") == tdb.settings("customdb")
    assert jdb.sim("customdb", "seq1", "p") == tdb.sim("customdb", "seq1",
                                                       "p")
    kj = jdb._load_plugin("kitti").settings()
    kt = tdb._load_plugin("kitti").settings()
    assert kj.keys() == kt.keys()
    for seq in kj["sequences"]:
        a = kj["sequences"][seq]["sim_steps"]["cam_motion"]
        b = kt["sequences"][seq]["sim_steps"]["cam_motion"]
        assert np.array_equal(a, b)

    rgb = os.path.join(jp.images["seqA"])
    names = tlog.natural_listdir(rgb)
    assert names == jlog.natural_listdir(rgb) == ["2.npy", "10.npy"]
    img, dep = (os.path.join(rgb, names[1]),
                os.path.join(jp.depth["seqA"], names[1]))
    for a, b in zip(jio.load_frame(img, dep, 1, 1),
                    tio.load_frame(img, dep, 1, 1)):
        assert np.array_equal(a, b)
    grid = np.arange(30).reshape(5, 6)
    assert np.array_equal(tio.crop_center(grid, 3, 2),
                          jio.crop_center(grid, 3, 2))
    assert list(tio.prefetch_map(lambda v: v * 2, range(11), depth=3)) == \
        list(range(0, 22, 2))


def test_cityscapes_plugin_matches(tmp_path):
    """The port's Cityscapes plugin finds the same sequences (PNG
    folders, depth folders excluded), paths, settings (render_scale and
    depth_scale 2) and per-sequence simulation as raintpu's."""
    root = tmp_path / "cityscapes"
    for rel in ("leftImg8bit/train/aachen", "leftImg8bit/val/lindau",
                "leftImg8bit/train/depth/aachen"):
        (root / rel).mkdir(parents=True)
        (root / rel / "f_000000.png").write_bytes(b"")
    (root / "leftImg8bit" / "empty").mkdir()

    def params():
        from types import SimpleNamespace
        return SimpleNamespace(images_root=str(root),
                               dataset_root=str(root),
                               depth_root=str(tmp_path / "depth"))

    jp = jdb.resolve_paths("cityscapes", params())
    tp = tdb.resolve_paths("cityscapes", params())
    assert list(jp.sequences) == list(tp.sequences) == [
        os.path.join("leftImg8bit", "train", "aachen"),
        os.path.join("leftImg8bit", "val", "lindau")]
    for attr in ("images", "depth", "calib"):
        assert getattr(jp, attr) == getattr(tp, attr)
    js, ts = jdb.settings("cityscapes"), tdb.settings("cityscapes")
    assert ts["render_scale"] == ts["depth_scale"] == 2
    assert js.keys() == ts.keys()
    for k in js:
        if k != "sequences":
            assert js[k] == ts[k], k
    seq = os.path.join("leftImg8bit", "train", "aachen")
    jsim_, tsim_ = (db.sim("cityscapes", seq, "p") for db in (jdb, tdb))
    assert jsim_["path"] == tsim_["path"] == os.path.join("p", "leftImg8bit")
    jo, to = jsim_["options"], tsim_["options"]
    assert jo.keys() == to.keys()
    assert np.array_equal(jo["sim_steps"]["cam_motion"],
                          to["sim_steps"]["cam_motion"])
    assert {k: v for k, v in jo.items() if k != "sim_steps"} == \
        {k: v for k, v in to.items() if k != "sim_steps"}
