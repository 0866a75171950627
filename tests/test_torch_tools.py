"""The port's host and profiling tools against raintpu's.

- ``render.geometry``: the KITTI calib parse exactly equal; the
  back-projection, drop distances and ground intersections within 1e-5
  (float32 products summed in another order).
- ``tools.check_difference``: equal reports on the same two trees.
- ``tools.smooth_depth``: ``improve_depth``, with and without far
  planes, against raintpu's cv2 version within atol 1e-4 m + rtol 1e-5
  (cv2's Gaussian sums its taps in another order; the far-plane masks
  are equal); ``process_all`` writes the same files to that bar.
- ``tools.stage_profile`` on a tiny scene on the CPU: the JAX tool's
  stage and delta keys, every stage time > 0.
- ``utils.logging``: the added helpers print what raintpu's print.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.render import geometry as jgeo
from raintpu.tools import check_difference as jdiff
from raintpu.tools import smooth_depth as jsmooth
from raintpu.utils import logging as jlog
from raintpu_torch.data import db as tdb
from raintpu_torch.data.datasets import nuscenes as tnusc
from raintpu_torch.render import camera as tcam
from raintpu_torch.render import geometry as tgeo
from raintpu_torch.tools import check_difference as tdiff
from raintpu_torch.tools import smooth_depth as tsmooth
from raintpu_torch.tools import stage_profile as tprof
from raintpu_torch.utils import logging as tlog
from torch_cpu_threads import one_torch_thread  # noqa: F401

GEO_TOL = dict(atol=1e-5, rtol=1e-5)
DEPTH_TOL = dict(atol=1e-4, rtol=1e-5)
# raintpu/tools/stage_profile.py: its stages and deltas.
JAX_STAGES = {"fog", "fog+envmap", "bg", "prep_photo", "prep_geom", "prep",
              "fields", "full"}
JAX_DELTAS = {"fog", "envmap (fog+envmap-fog)", "bg",
              "photometry (prep_photo-bg)", "geometry (prep_geom-photo)",
              "coefs+route (prep-geom)", "prep-bg", "kernel (fields-prep)",
              "finalize (full-fields)"}


def _calib_file(tmp_path):
    p = os.path.join(str(tmp_path), "calib_cam_to_cam.txt")
    with open(p, "w") as fh:
        fh.write("calib_time: now\n")
        fh.write("R_rect_02: 0.9999 0.0093 -0.0059 -0.0093 0.9999 0.0023 "
                 "0.0059 -0.0023 1.0\n")
        fh.write("P_rect_02: 721.5 0 609.5 44.85 0 721.5 172.8 0.2163 "
                 "0 0 1 0.002745\n")
        fh.write("R_rect_03: 1 0 0 0 1 0 0 0 1\n")
        fh.write("P_rect_03: 721.5 0 609.5 -339.5 0 721.5 172.8 2.2 "
                 "0 0 1 0.0027\n")
    return p


@pytest.mark.parametrize("camera", [2, 3])
def test_geometry_matches_raintpu(tmp_path, camera):
    path = _calib_file(tmp_path)
    j = jgeo.parse_kitti_calib(path, camera)
    t = tgeo.parse_kitti_calib(path, camera)
    np.testing.assert_array_equal(t.p_rect, j.p_rect)
    np.testing.assert_array_equal(t.r_rect, j.r_rect)
    np.testing.assert_array_equal(t.projection, j.projection)
    assert t.cam_offset_x == j.cam_offset_x

    rng = np.random.RandomState(camera)
    depth = (rng.rand(36, 124) * 60 + 2).astype(np.float32)
    jp = np.array(jgeo.backproject_depth(jnp.asarray(depth), j.projection))
    tp = tgeo.backproject_depth(torch.as_tensor(depth), t.projection)
    np.testing.assert_allclose(tp.numpy(), jp, **GEO_TOL)

    drops = rng.randn(5, 3).astype(np.float32) * 3
    jd = np.asarray(jgeo.drop_distance_map(jnp.asarray(jp),
                                           jnp.asarray(drops)))
    td = tgeo.drop_distance_map(torch.as_tensor(jp), torch.as_tensor(drops))
    assert td.shape == (5, 36, 124)
    np.testing.assert_allclose(td.numpy(), jd, **GEO_TOL)

    u = (rng.rand(7, 3) * 1240).astype(np.float32)
    v = (rng.rand(7, 3) * 375).astype(np.float32)
    jg = np.asarray(jgeo.pixel_ray_ground_intersection(
        jnp.asarray(u), jnp.asarray(v), j.projection))
    tg = tgeo.pixel_ray_ground_intersection(
        torch.as_tensor(u), torch.as_tensor(v), t.projection)
    assert tg.shape == (7, 3, 3)
    np.testing.assert_allclose(tg.numpy(), jg, **GEO_TOL)


def test_geometry_refuses_a_missing_camera(tmp_path):
    with pytest.raises(ValueError, match="cam 0"):
        tgeo.parse_kitti_calib(_calib_file(tmp_path), 0)


def _png_trees(tmp_path):
    left, right = str(tmp_path / "L"), str(tmp_path / "R")
    for root in (left, right):
        os.makedirs(os.path.join(root, "seq", "rain_mask"))
    rng = np.random.RandomState(0)
    same = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    diff = same.copy()
    diff[0, 0] += 13
    mask = (rng.rand(8, 8) > 0.5).astype(np.uint8) * 255
    mask2 = mask.copy()
    mask2[:2] = 255
    for root, b, m in ((left, same, mask), (right, diff, mask2)):
        Image.fromarray(same).save(os.path.join(root, "seq", "a.png"))
        Image.fromarray(b).save(os.path.join(root, "seq", "b.png"))
        Image.fromarray(m).save(os.path.join(root, "seq", "rain_mask",
                                             "m.png"))
    Image.fromarray(same).save(os.path.join(left, "seq", "only.png"))
    Image.fromarray(same).save(os.path.join(right, "seq", "right.png"))
    return left, right


def test_check_difference_matches_raintpu(tmp_path, capsys):
    left, right = _png_trees(tmp_path)
    want = jdiff.compare_trees(left, right, verbose=True)
    jout = capsys.readouterr().out
    got = tdiff.compare_trees(left, right, verbose=True)
    assert got == want
    assert capsys.readouterr().out == jout
    assert got["identical"] == 1 and got["different"] == 2
    assert got["left_only"] == got["right_only"] == 1
    out = str(tmp_path / "report.json")
    assert tdiff.main([left, right, "--json", out]) == 0
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(want))
    a = np.zeros((10, 10))
    b = np.zeros((10, 10))
    a[2:6, 2:6] = 1
    b[3:7, 3:7] = 1
    assert tdiff.mask_iou(a, b) == jdiff.mask_iou(a, b) == 9 / 23.0


def _depth_case(hw, seed):
    """A gray image with flat blocks and texture, and a noisy depth."""
    rng = np.random.RandomState(seed)
    h, w = hw
    gray = (rng.rand(h, w) * 255).astype(np.uint8)
    gray[3:35, 5:60] = 77
    gray[h // 2:, w // 2:] = 200
    depth = (rng.rand(h, w) * 50 + 1).astype(np.float32)
    return gray, depth


@pytest.mark.parametrize("hw", [(64, 96), (90, 160), (37, 53)])
@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("threshold", [0.001, 0.5])
def test_improve_depth_matches_raintpu(hw, far, threshold):
    gray, depth = _depth_case(hw, sum(hw))
    want = jsmooth.improve_depth(gray, depth, threshold, far)
    got = tsmooth.improve_depth(torch.as_tensor(gray),
                                torch.as_tensor(depth), threshold, far)
    assert got.dtype == torch.float32 and got.shape == depth.shape
    np.testing.assert_allclose(got.numpy(), want, **DEPTH_TOL)
    if far and min(hw) > 40:
        assert (want > 250).sum() > 100, "the far planes must be set"


def test_far_plane_mask_equals_the_patch_loop():
    """The max-pool of the grid's flat centres sets the same pixels as
    the reference's loop over patches."""
    gray, _ = _depth_case((70, 130), 1)
    g = torch.as_tensor(gray)
    for window in (20, 9, 5):
        got = tsmooth.far_plane_mask(g, 0.001, window).numpy()
        mean = tsmooth.box_filter(g.float(), window)
        sq = tsmooth.box_filter(g.float() ** 2, window)
        flat = (torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
                < 0.001).numpy()
        want = np.zeros_like(got)
        step = max(window // 5, 1)
        for y in range(0, 70 - window, step):
            for x in range(0, 130 - window, step):
                if flat[y + window // 2, x + window // 2]:
                    want[y:y + window, x:x + window] = True
        np.testing.assert_array_equal(got, want)
        assert want.any()


def test_smooth_depth_process_all_matches_raintpu(tmp_path):
    gray, depth = _depth_case((48, 80), 7)
    img_dir, dep_dir = str(tmp_path / "rgb"), str(tmp_path / "dep")
    os.makedirs(img_dir)
    os.makedirs(dep_dir)
    for i in range(2):
        Image.fromarray(np.roll(gray, i, 0)).save(
            os.path.join(img_dir, f"{i}.png"))
        Image.fromarray((np.roll(depth, i, 1) * 256).astype(np.uint16)).save(
            os.path.join(dep_dir, f"{i}.png"))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jsmooth.process_all(img_dir, dep_dir, jout, 0.001, True) == 2
    assert tsmooth.main([img_dir, dep_dir, tout, "--threshold", "0.001",
                         "--far_planes", "--device", "cpu"]) == 0
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout)) == ["0.png.npy", "1.png.npy"]
    for n in names:
        np.testing.assert_allclose(np.load(os.path.join(tout, n)),
                                   np.load(os.path.join(jout, n)),
                                   **DEPTH_TOL)


def test_stage_profile_on_the_cpu(capsys):
    rec = tprof.main(["--batch", "1", "--iters", "1", "--reps", "1",
                      "--hw", "96", "160", "--capacity", "64",
                      "--device", "cpu", "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(rec))
    assert set(rec["ms_per_step"]) == JAX_STAGES
    assert set(rec["deltas_ms"]) == JAX_DELTAS
    assert all(v > 0 for v in rec["ms_per_step"].values())
    assert rec["batch"] == 1 and rec["backend"] == "cpu"


@pytest.mark.parametrize("camera", ["rig", "plugin"])
def test_stage_profile_sizes_the_nuscenes_rig(camera):
    """--nuscenes: 6 frames of 1600x900 at 100 mm/hr, the simulation
    capacity the expected count + 5 sigma rounded up to 256, as raintpu's
    tool sizes it (the workload itself is built on the card). The same
    sizing at the nuScenes plugin's camera gives the CLI's capacity."""
    args = tprof.parse_args(["--nuscenes", "--device", "cpu"])
    assert (args.batch, tuple(args.hw), args.fallrate) == (6, (900, 1600),
                                                           100.0)
    if camera == "rig":
        kw = dict(wh=(1600, 900), ccd_wh=(1600, 900))
        jset = jcam.RenderSettings(camera=jcam.CameraSettings(**kw))
        tset = tcam.RenderSettings(camera=tcam.CameraSettings(**kw))
    else:
        d = {**tdb.default_settings(), **tnusc.settings()}
        jset, tset = jcam.settings_from_dict(d), tcam.settings_from_dict(d)
    probe = jsim.SimConfig.from_settings(jset, capacity=1)
    expect = jsim.expected_drop_count(probe, 100.0)
    want = int(-(-(expect + 5 * np.sqrt(expect)) // 256) * 256)
    assert tprof.full_population_capacity(tset, 100.0) == want
    assert want > {"rig": 8000, "plugin": 24000}[camera]


@pytest.mark.parametrize("name", ["print_error", "print_success"])
def test_logging_messages_match_raintpu(name, capsys):
    getattr(jlog, name)("boom")
    want = capsys.readouterr().out
    getattr(tlog, name)("boom")
    assert capsys.readouterr().out == want


def test_progress_bar_matches_raintpu(capsys):
    for i in (0, 3, 7):
        jlog.progress_bar(i, 7, prefix="p", length=20)
        want = capsys.readouterr().out
        tlog.progress_bar(i, 7, prefix="p", length=20)
        assert capsys.readouterr().out == want
