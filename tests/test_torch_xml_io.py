"""The port's particle-XML interchange against raintpu's.

The same raw frames through both writers give the same bytes; both of
the port's parsers (ElementTree, and the native one it builds from its
own source) read a file into exactly raintpu's records, self-closing
empty frames included, and refuse a corrupted file as "corrupted";
``load_streaks`` gives raintpu's records exactly (render_scale 1 and 2,
the ``nuscenes_gan`` rescale), and each package reads the other's
``.npz`` cache; ``batch_to_raw_frames`` of the same drops gives the
same raw frames; and a simulation written by the port's tool reads
back with every frame's drop count."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.particles import schema as jschema
from raintpu.particles import xml_io as jxml
from raintpu.physics import simulator as jsim
from raintpu_torch import interop
from raintpu_torch.particles import native as tnative
from raintpu_torch.particles import schema as tschema
from raintpu_torch.particles import xml_io as txml
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render.camera import settings_from_dict
from raintpu_torch.tools import particles_simulation as ttool
from torch_cpu_threads import one_torch_thread  # noqa: F401

RAW_KEYS = ("pid", "ip1", "ip2", "iw1", "iw2", "wp1", "wp2", "wd1", "wd2")
REC_KEYS = ("ip1", "ip2", "iw1", "iw2", "wp1", "wp2", "max_width", "length",
            "ratio", "drop_type")


def _raw_frames(n_frames=4, n_drops=30, seed=0):
    """Sim-space raw frames (bottom-origin image y, z negative forward),
    frame 2 empty."""
    rng = np.random.RandomState(seed)
    frames = []
    for f in range(n_frames):
        n = 0 if f == 2 else n_drops
        x = rng.uniform(-20, 280, n)
        y = rng.uniform(-10, 140, n)
        ln = rng.uniform(2, 40, n)
        w = rng.uniform(0.5, 9, n)
        z = rng.uniform(0.3, 9, n)
        frames.append({
            "id": f, "exposure": 2000, "start": f * 100000,
            "pid": np.arange(n) + 3,
            "ip1": np.stack([x, y + ln], -1), "ip2": np.stack([x + 2, y], -1),
            "iw1": w, "iw2": w * 0.9,
            "wp1": np.stack([x / 100, np.ones(n), -z], -1),
            "wp2": np.stack([x / 100, np.full(n, 0.98), -z], -1),
            "wd1": np.full(n, 0.002), "wd2": np.full(n, 0.0018)})
    return frames


@pytest.fixture(scope="module")
def xml_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("xml") / "0000_camera0.xml")
    jxml.write_particles_xml(p, _raw_frames())
    return p


def _assert_raw_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("id", "exposure", "start", "count"):
            assert g[k] == w[k], k
        for k in RAW_KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_records_equal(got, want):
    assert sorted(got) == sorted(want)
    for fid in want:
        for k in REC_KEYS:
            assert got[fid][k].dtype == want[fid][k].dtype, k
            np.testing.assert_array_equal(got[fid][k], want[fid][k],
                                          err_msg=f"{fid} {k}")


@pytest.mark.parametrize("focal", [None, 300.0])
def test_writer_is_byte_identical(tmp_path, focal):
    cfg = jsim.SimConfig(image_wh=(256, 128), focal_px=(300.0, 300.0),
                         exposure_s=2e-3, capacity=64, z_max=8.0)
    batch = jsim.simulate_frames(jax.random.PRNGKey(1), cfg,
                                 jnp.full(3, 60.0), jnp.zeros(3),
                                 jnp.full(3, 2e-3), jnp.ones(3))
    raw = jxml.batch_to_raw_frames(batch, (256, 128), cam_hz=10.0,
                                   exposure_s=2e-3, focal_px=focal)
    for name, frames in (("sim", raw), ("synthetic", _raw_frames())):
        a, b = tmp_path / f"j_{name}.xml", tmp_path / f"t_{name}.xml"
        jxml.write_particles_xml(str(a), frames)
        txml.write_particles_xml(str(b), frames)
        assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("parser", ["python", "native"])
def test_parse_equals_raintpu(xml_file, parser):
    if parser == "native":
        assert tnative.available(), "g++ builds the port's parser here"
    before = dict(txml.parse_particles_xml_raw.parses)
    got = txml.parse_particles_xml_raw(xml_file,
                                       prefer_native=parser == "native")
    assert txml.parse_particles_xml_raw.parses[parser] == before[parser] + 1
    _assert_raw_equal(got, jxml.parse_particles_xml_raw(
        xml_file, prefer_native=False))
    assert [len(f["ip1"]) for f in got] == [30, 30, 0, 30]


@pytest.mark.parametrize("parser", ["python", "native"])
def test_parse_self_closing_empty_frames(tmp_path, parser):
    """A zero-drop frame written self-closing (<frame ... />) must not
    swallow the next frame's drops."""
    p = str(tmp_path / "0000_camera0.xml")
    with open(p, "w") as fh:
        fh.write(
            '<simulation>'
            '<frame id="0" t="2000" d="0" rs="0" />'
            '<frame id="1" t="2000" d="100" rs="1">'
            '<drop pid="7" wp1="(0.1;1.0;-2.0)" wp2="(0.1;0.98;-2.0)" '
            'wd1="0.002" wd2="0.002" ip1="(50;40)" ip2="(50;30)" '
            'iw1="2.0" iw2="1.8"/></frame>'
            '<frame id="2" t="2000" d="200" rs="0"></frame>'
            '<frame id="3" t="2000" d="300" rs="1">'
            '<drop pid="9" wp1="(0.2;1.0;-3.0)" wp2="(0.2;0.98;-3.0)" '
            'wd1="0.002" wd2="0.002" ip1="(80;70)" ip2="(80;60)" '
            'iw1="3.0" iw2="2.7"/></frame>'
            '</simulation>')
    got = txml.parse_particles_xml_raw(p, prefer_native=parser == "native")
    _assert_raw_equal(got, jxml.parse_particles_xml_raw(
        p, prefer_native=False))
    assert [len(f["ip1"]) for f in got] == [0, 1, 0, 1]
    assert got[3]["pid"][0] == 9 and got[3]["start"] == 300


@pytest.mark.parametrize("parser", ["python", "native"])
def test_corrupted_file_raises(tmp_path, parser):
    p = str(tmp_path / "bad_camera0.xml")
    with open(p, "w") as fh:
        fh.write("<simulation><frame id=")
    with pytest.raises(RuntimeError, match="corrupted"):
        txml.parse_particles_xml_raw(p, prefer_native=parser == "native")


@pytest.mark.parametrize("image_wh,render_scale,dataset", [
    ((256, 128), 1, None), ((128, 64), 2, None),
    ((200, 113), 1, "nuscenes_gan")])
def test_load_streaks_equals_raintpu(xml_file, image_wh, render_scale,
                                     dataset):
    kw = dict(image_wh=image_wh, render_scale=render_scale,
              dataset=dataset, use_cache=False)
    got = txml.load_streaks(xml_file, **kw)
    want = jxml.load_streaks(xml_file, **kw)
    _assert_records_equal(got, want)
    assert sum(len(r["ip1"]) for r in got.values()) > 5


@pytest.mark.parametrize("writer", ["raintpu", "port"])
def test_cache_is_read_across_packages(tmp_path, monkeypatch, writer):
    p = str(tmp_path / "0000_camera0.xml")
    jxml.write_particles_xml(p, _raw_frames(seed=4))
    first, second = (jxml, txml) if writer == "raintpu" else (txml, jxml)
    written = first.load_streaks(p, image_wh=(256, 128))
    assert os.path.exists(p + ".npz")

    def no_parse(*args, **kw):
        raise AssertionError("the reader parsed the file, not the cache")

    monkeypatch.setattr(second, "parse_particles_xml_raw", no_parse)
    read = second.load_streaks(p, image_wh=(256, 128))
    _assert_records_equal(read, written)
    with np.load(p + ".npz") as data:
        assert json.loads(str(data["meta_key"]))[0] == txml.CACHE_VERSION


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("focal", [None, 310.0])
def test_batch_to_raw_frames_equals_raintpu(batched, focal):
    cfg = jsim.SimConfig(image_wh=(256, 128), focal_px=(300.0, 300.0),
                         exposure_s=2e-3, capacity=64, z_max=8.0,
                         render_scale=2.0)
    batch = jsim.simulate_frames(jax.random.PRNGKey(2), cfg,
                                 jnp.full(2, 80.0), jnp.zeros(2),
                                 jnp.full(2, 2e-3), jnp.ones(2))
    if not batched:
        batch = jax.tree.map(lambda a: a[1], batch)
    port = interop.drop_batch_from_numpy(interop.numpy_fields(batch),
                                         device="cpu")
    kw = dict(image_wh=(256, 128), cam_hz=10.0, exposure_s=2e-3,
              render_scale=2.0, focal_px=focal)
    got = txml.batch_to_raw_frames(port, **kw)
    want = jxml.batch_to_raw_frames(batch, **kw)
    assert len(got) == (2 if batched else 1)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("id", "exposure", "start"):
            assert g[k] == w[k]
        for k in RAW_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_tool_simulation_round_trip(tmp_path):
    """The port's tool on the CPU writes the reference layout; every
    frame reads back with its simulated drop count, and raintpu's reader
    gives the same records as the port's."""
    options = {"cam_WH": [192, 96], "cam_CCD_WH": [192, 96],
               "cam_CCD_pixsize": 20.0, "cam_focal": 8, "cam_hz": 10,
               "cam_exposure": 2, "sim_mode": "normal",
               "sim_duration": 0.4}
    out = str(tmp_path / "rain" / "40mm")
    weather = {"weather": "rain", "fallrate": 40}
    path = ttool.simulate_to_xml(out, options, weather, capacity=256,
                                 seed=3, verbose=False, device="cpu")
    assert path == os.path.join(out, "0000_camera0.xml")
    assert sorted(os.listdir(out)) == ["0000_camera0.xml",
                                       "automate_log.txt", "sim_options.json"]
    with open(os.path.join(out, "sim_options.json")) as fh:
        assert json.load(fh)["cam_WH"] == [192, 96]
    # An existing simulation is kept.
    assert ttool.simulate_to_xml(out, options, weather, verbose=False,
                                 device="cpu") == path

    settings = settings_from_dict(options)
    cfg = tsim.SimConfig.from_settings(settings, capacity=256)
    sched = [torch.as_tensor(a) for a in
             tsim.schedule_from_settings(settings, 40)]
    batch = tsim.simulate_frames(torch.Generator().manual_seed(3), cfg,
                                 *sched)
    counts = batch.count().tolist()
    assert len(counts) == 4 and min(counts) > 0
    got = txml.load_streaks(path, image_wh=(192, 96), use_cache=False)
    assert [len(got[i]["ip1"]) for i in range(4)] == counts
    _assert_records_equal(got, jxml.load_streaks(path, image_wh=(192, 96),
                                                 use_cache=False))
    v0 = batch.valid[0]
    np.testing.assert_allclose(np.sort(got[0]["ip1"], axis=0),
                               np.sort(batch.ip1[0][v0].numpy(), axis=0))


def test_packing_matches_raintpu():
    """A batch packed on the host equals raintpu's per-frame packing,
    frames the file lacks included (its empty_drop_batch)."""
    frames = _raw_frames(seed=6)
    rec = jschema.finalize_raw_streaks(
        frames[0]["ip1"], frames[0]["ip2"], frames[0]["iw1"],
        frames[0]["iw2"], frames[0]["wp1"], frames[0]["wp2"], (256, 128))
    cap = 24
    assert len(rec["ip1"]) > cap   # the widest drops are kept
    got = tschema.pack_drop_batches([rec, None], cap, device="cpu")
    for b, want in enumerate([jschema.pack_drop_batch(rec, cap),
                              jschema.empty_drop_batch(cap)]):
        for k, arr in interop.numpy_fields(want).items():
            one = getattr(got, k)[b].numpy()
            assert one.dtype == arr.dtype, k
            np.testing.assert_array_equal(one, arr, err_msg=f"{b} {k}")
    empty = tschema.empty_drop_batch(cap, device="cpu")
    assert all(torch.equal(getattr(empty, k), getattr(got, k)[1])
               for k in REC_KEYS + ("valid",))
