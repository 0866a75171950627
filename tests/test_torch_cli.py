"""The port's CLI against raintpu's: the same resolution of a dataset
into sequences, weather, settings and JobSpec fields, and an online
render end to end on the CPU (``--device cpu``)."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from raintpu import cli as jcli
from raintpu_torch import cli as tcli
from raintpu_torch.render import online as tonline

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


def test_unported_modes_raise(ds):
    offline = [a for a in ARGS if a != "--online"]
    with pytest.raises(NotImplementedError, match="xml_io"):
        tcli.check_args(offline)
    with pytest.raises(NotImplementedError, match="xml_io"):
        tcli.main(ARGS + ["--device", "cpu", "--export_xml"])
