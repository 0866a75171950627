"""The port's render farm (``raintpu_torch.main_threaded``) against the
root ``main_threaded.py``: the same shards, tags and child arguments
(only the child command's head differs: ``python -m raintpu_torch.cli``
instead of the path of ``main.py``), the same scheduler, and one real
farm run on the CPU whose outputs equal a single CLI job's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from raintpu_torch import cli as tcli
from raintpu_torch import main_threaded as farm
from torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import main_threaded as root_farm  # noqa: E402


class NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


# The argument sets of tests/test_main_threaded.py.
ARG_SETS = {
    "intensity_x_scenes": (dict(dataset="kitti", intensity="5,25",
                                sequences="a,b,c", scenes_per_thread=2),
                           ["--extra", "1"]),
    "no_sequences": (dict(dataset="toy", intensity="10", sequences="",
                          scenes_per_thread=25), []),
    "frame_windows": (dict(dataset="kitti", intensity="5,25",
                           sequences="a,b,c", scenes_per_thread=2,
                           frames_per_thread=41, frame_start=0,
                           frame_end=100), []),
    "frame_bounds_without_windows": (dict(dataset="toy", intensity="10",
                                          sequences="", scenes_per_thread=25,
                                          frames_per_thread=0, frame_start=5,
                                          frame_end=9), []),
}


@pytest.mark.parametrize("name", sorted(ARG_SETS))
def test_build_shards_matches_the_root_farm(name):
    kw, passthrough = ARG_SETS[name]
    want = root_farm.build_shards(NS(**kw), list(passthrough))
    got = farm.build_shards(NS(**kw), list(passthrough))
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert w[1].endswith("main.py")
        assert g[:3] == [sys.executable, "-m", "raintpu_torch.cli"]
        assert g[3:] == w[2:]
    assert len(got) == {"intensity_x_scenes": 4, "no_sequences": 1,
                        "frame_windows": 12,
                        "frame_bounds_without_windows": 1}[name]


def test_frames_per_thread_requires_frame_end():
    args = NS(dataset="toy", intensity="10", sequences="",
              scenes_per_thread=25, frames_per_thread=10, frame_start=0,
              frame_end=None)
    with pytest.raises(SystemExit, match="frame_end"):
        root_farm.build_shards(args, [])
    with pytest.raises(SystemExit, match="frame_end"):
        farm.build_shards(args, [])


def test_scheduler_runs_shards_and_reports_failures(tmp_path, monkeypatch):
    """The scheduler loop with stand-in children: logs written,
    concurrency respected, nonzero exits collected."""

    def fake_shards(args, passthrough):
        ok = [sys.executable, "-c",
              "import sys; print('child ok'); sys.exit(0)"]
        bad = [sys.executable, "-c", "import sys; sys.exit(3)"]
        return [("s0", ok), ("s1", bad), ("s2", ok)]

    monkeypatch.setattr(farm, "build_shards", fake_shards)
    monkeypatch.setattr(farm.time, "sleep", lambda s: None)
    rc = farm.main(["--dataset", "toy", "--max_threads", "2",
                    "--log_dir", str(tmp_path)])
    assert rc == 1  # one shard failed
    logs = sorted(p.name for p in tmp_path.iterdir())
    assert "automate_log_s0.txt" in logs
    assert "automate_error_s1.txt" in logs
    assert "child ok" in (tmp_path / "automate_log_s0.txt").read_text()

    def all_ok(args, passthrough):
        return [("a", [sys.executable, "-c", "pass"])]

    monkeypatch.setattr(farm, "build_shards", all_ok)
    assert farm.main(["--dataset", "toy", "--log_dir", str(tmp_path)]) == 0


def test_children_find_the_package(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", "elsewhere")
    path = farm.child_env()["PYTHONPATH"].split(os.pathsep)
    assert path == [REPO, "elsewhere"]
    assert os.path.isdir(os.path.join(path[0], "raintpu_torch"))


def _tree(root):
    """{relative path: array} of every .npy under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npy"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = np.load(p)
    return out


def _mtimes(root):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


def _farm(args, log_dir):
    """``python -m raintpu_torch.main_threaded`` from another directory,
    one PyTorch thread a child."""
    proc = subprocess.run(
        [sys.executable, "-m", "raintpu_torch.main_threaded", *args,
         "--log_dir", str(log_dir)], capture_output=True, text=True,
        timeout=240, cwd=log_dir,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_farm_renders_what_one_job_renders(tmp_path):
    """Two frame windows of a tiny customdb tree rendered by two child
    jobs on the CPU equal one CLI job over the same frames; a second
    farm run skips every frame and rewrites nothing."""
    rng = np.random.RandomState(0)
    seq = tmp_path / "source" / "customdb" / "drive"
    for sub in ("rgb", "depth"):
        (seq / sub).mkdir(parents=True)
    for i in range(4):
        np.save(seq / "rgb" / f"{i:06d}.npy",
                (rng.rand(24, 48, 3) * 255).astype(np.uint8))
        np.save(seq / "depth" / f"{i:06d}.npy",
                (rng.rand(24, 48) * 40 + 3).astype(np.float32))
    src = str(tmp_path / "source")
    common = ["-k", src, "-d", src, "--online", "--device", "cpu",
              "--batch_size", "2", "--drop_capacity", "128", "--seed", "4",
              "--save_format", "npy", "--save_saturation", "--save_envmap"]
    logs = tmp_path / "logs"
    logs.mkdir()
    farm_out = str(tmp_path / "farm")
    shards = ["--dataset", "customdb", "--intensity", "25",
              "--frames_per_thread", "2", "--frame_end", "4",
              "--max_threads", "2", "--output", farm_out, *common]
    printed = _farm(shards, logs)
    assert "2 shard(s), 2 concurrent" in printed
    assert "All shards completed" in printed
    for tag in ("i25_s0_f0", "i25_s0_f2"):
        assert "'rendered': 2" in (logs / f"automate_log_{tag}.txt"
                                   ).read_text()

    one_out = str(tmp_path / "one")
    assert tcli.main(["--dataset", "customdb", "--intensity", "25",
                      "--frame_end", "4", "--noverbose", "--output",
                      one_out, *common]) == 0
    got, want = _tree(farm_out), _tree(one_out)
    assert len(want) == 4 * 4 and sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].astype(np.float64),
                                   want[name].astype(np.float64),
                                   atol=1e-5, err_msg=name)

    before = _mtimes(farm_out)
    _farm(shards, logs)
    for tag in ("i25_s0_f0", "i25_s0_f2"):
        text = (logs / f"automate_log_{tag}.txt").read_text()
        assert "'rendered': 0" in text and "'skipped': 2" in text, text
    assert _mtimes(farm_out) == before
