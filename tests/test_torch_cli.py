"""The port's CLI against raintpu's: the same resolution of a dataset
into sequences, weather, settings, particle files and JobSpec fields,
and the online and offline renders and the XML export end to end on the
CPU (``--device cpu``)."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from raintpu import cli as jcli
from raintpu_torch import cli as tcli
from raintpu_torch.render import online as tonline
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARGS = ["--dataset", "customdb", "--intensity", "5,25", "--online",
        "--batch_size", "2", "--drop_capacity", "128", "--seed", "4",
        "--frame_end", "3", "--save_format", "npy", "--save_saturation",
        "--save_envmap", "--noverbose"]


@pytest.fixture()
def ds(tmp_path, monkeypatch):
    """customdb layout under tmp/data/source/customdb, .npy frames."""
    rng = np.random.RandomState(0)
    base = tmp_path / "data" / "source" / "customdb"
    for seq in ("seqA", "seqB"):
        for sub in ("rgb", "depth"):
            (base / seq / sub).mkdir(parents=True)
        for i in range(3):
            np.save(base / seq / "rgb" / f"{i:06d}.npy",
                    (rng.rand(24, 48, 3) * 255).astype(np.uint8))
            np.save(base / seq / "depth" / f"{i:06d}.npy",
                    (rng.rand(24, 48) * 40 + 3).astype(np.float32))
    monkeypatch.chdir(tmp_path)
    return tmp_path


class _Capture:
    """Stands in for a job class: keeps the JobSpec, renders nothing."""

    specs = []

    def __init__(self, spec):
        self.specs.append(spec)

    def run(self):
        return {"rendered": 0}


def test_check_args_and_job_spec_match(ds, monkeypatch, tmp_path):
    j, t = jcli.check_args(ARGS), tcli.check_args(ARGS)
    assert sorted(j.sequences) == sorted(t.sequences) == ["seqA", "seqB"]
    for name in ("weather", "settings", "particles", "images", "depth",
                 "calib"):
        assert getattr(j, name) == getattr(t, name), name
    for name in ("texture", "norm_coeff", "intensity", "frames", "verbose",
                 "dataset_root", "depth_root", "online"):
        assert getattr(j.args, name) == getattr(t.args, name), name
    assert t.args.device == "cuda"

    import raintpu.render.online as jonline
    monkeypatch.setattr(jonline, "OnlineRenderJob", _Capture)
    monkeypatch.setattr(tonline, "OnlineRenderJob", _Capture)
    # raintpu's main points jax's compile cache at this directory.
    monkeypatch.setenv("RAINTPU_COMPILE_CACHE", str(tmp_path / "jc"))
    before = jax.config.jax_compilation_cache_dir
    _Capture.specs = []
    try:
        assert jcli.main(ARGS) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert tcli.main(ARGS + ["--device", "cpu"]) == 0
    jspec, tspec = _Capture.specs
    jd, td = dataclasses.asdict(jspec), dataclasses.asdict(tspec)
    assert td.pop("device") == "cpu"
    assert jd == td


def test_main_renders_online_on_the_cpu(ds, capsys):
    assert tcli.main(ARGS + ["--device", "cpu", "--sequences", "seqA",
                             "--intensity", "25"]) == 0
    out = os.path.join("data", "output", "customdb", "seqA", "rain", "25mm")
    names = [f"{i:06d}.npy" for i in range(3)]
    for sub in ("rainy_image", "rain_mask", "saturation_mask"):
        assert sorted(os.listdir(os.path.join(out, sub))) == names
    assert sorted(os.listdir(os.path.join(
        "data", "output", "customdb", "seqA", "envmap"))) == names
    img = np.load(os.path.join(out, "rainy_image", names[0]))
    assert img.dtype == np.uint8 and img.shape == (24, 48, 3)
    assert "'rendered': 3" in capsys.readouterr().out


# customdb's settings shrunk to the test frames (48x24, a 0.5 s
# simulation: 5 frames), in both packages' plugin.
SMALL = {"cam_WH": [48, 24], "cam_CCD_WH": [48, 24], "cam_CCD_pixsize": 20.0,
         "cam_focal": 8, "sim_mode": "normal", "sim_duration": 0.5,
         "sequences": {}}


@pytest.fixture()
def small(ds, monkeypatch):
    import raintpu.data.datasets.customdb as jcustom
    import raintpu_torch.data.datasets.customdb as tcustom
    for mod in (jcustom, tcustom):
        full = mod.settings()
        monkeypatch.setattr(mod, "settings", lambda full=full: {**full,
                                                                **SMALL})
    return ds


def test_check_args_offline_simulates_missing_files(small):
    """Without --online the port simulates the missing particle files
    (on the CPU here) and resolves the same paths as raintpu, which then
    finds them and simulates nothing."""
    offline = [a for a in ARGS if a != "--online"]
    t = tcli.check_args(offline + ["--device", "cpu"])
    assert sorted(t.particles) == ["seqA", "seqB"]
    for seq, paths in t.particles.items():
        assert [os.path.dirname(p) for p in paths] == [
            os.path.join("data", "particles", "customdb", seq, "rain",
                         f"{i}mm") for i in (5, 25)]
        for p in paths:
            assert sorted(os.listdir(os.path.dirname(p))) == [
                "0000_camera0.xml", "automate_log.txt", "sim_options.json"]
    mtimes = {p: os.path.getmtime(p) for ps in t.particles.values()
              for p in ps}
    j = jcli.check_args(offline)
    assert j.particles == t.particles and j.sequences == t.sequences
    assert {p: os.path.getmtime(p) for p in mtimes} == mtimes
    assert tcli.particles_glob("a", {"weather": "rain", "fallrate": 5}) \
        == jcli.particles_glob("a", {"weather": "rain", "fallrate": 5})


def test_main_renders_offline_on_the_cpu(small, capsys):
    """The offline path end to end: the tool writes the XML, the native
    parser reads it, the ladder is fitted, every frame is rendered."""
    from raintpu_torch.particles import xml_io

    before = dict(xml_io.parse_particles_xml_raw.parses)
    offline = [a for a in ARGS if a != "--online"]
    assert tcli.main(offline + ["--device", "cpu", "--sequences", "seqA",
                                "--intensity", "200",
                                "--raster_profile", "fitted"]) == 0
    assert xml_io.parse_particles_xml_raw.parses["native"] == \
        before["native"] + 1
    xml = os.path.join("data", "particles", "customdb", "seqA", "rain",
                       "200mm", "0000_camera0.xml")
    assert os.path.exists(xml + ".npz")
    out = os.path.join("data", "output", "customdb", "seqA", "rain",
                       "200mm")
    names = [f"{i:06d}.npy" for i in range(3)]
    for sub in ("rainy_image", "rain_mask", "saturation_mask"):
        assert sorted(os.listdir(os.path.join(out, sub))) == names
    mass = sum(float(np.load(os.path.join(out, "rain_mask", n)).sum())
               for n in names)
    assert mass > 0
    assert "'rendered': 3" in capsys.readouterr().out


def test_main_exports_xml_online(small, monkeypatch, capsys):
    """--online --export_xml writes the file finish_export names, in the
    layout the offline mode reads, and every frame reads back with the
    valid count of its simulation."""
    from raintpu_torch.particles import xml_io

    jobs = []
    run = tonline.OnlineRenderJob.run
    monkeypatch.setattr(tonline.OnlineRenderJob, "run",
                        lambda self: jobs.append(self) or run(self))
    assert tcli.main(ARGS + ["--device", "cpu", "--sequences", "seqA",
                             "--intensity", "200", "--export_xml"]) == 0
    path = os.path.join("data", "particles", "customdb", "seqA", "rain",
                        "200mm", "0000_camera0.xml")
    assert f"Exported particle XML: {path}" in capsys.readouterr().out
    streaks = xml_io.load_streaks(path, image_wh=(48, 24), use_cache=False)
    assert sorted(streaks) == [0, 1, 2]
    counts = [int(jobs[0]._drops_for_frame(i).count()) for i in range(3)]
    assert [len(streaks[i]["ip1"]) for i in range(3)] == counts
    assert sum(counts) > 0
