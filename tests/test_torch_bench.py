"""The port's headline benchmark (``raintpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU at a tiny size.

``main()`` runs as ``tests/test_bench.py`` runs raintpu's: HW 96x256,
batch 2, 2 timed steps, capacity 64, here with DEVICE=cpu. Its last
line holds exactly the port's keys, positive rates and bench.py's hand
ladder, read from bench.py's source (the JAX bench builds it inside its
``main()``). The workload's inputs are the JAX bench's: the same camera
and simulation settings, frames and depth maps from RandomState(0), the
same texture bank. The guards raise on a render without rain and on
one with overflow, and without a card the bench refuses to start.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raintpu.data import textures as jtex
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu_torch import bench
from raintpu_torch.physics import simulator as tsim
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = {"HW": "96x256", "BATCH": "2", "ITERS": "2", "CAPACITY": "64",
        "DEVICE": "cpu"}
KEYS = {"metric", "value", "unit", "steady_state", "fields_dtype",
        "modal_blur", "cone_downsample", "ladder", "device", "launches"}


def _jax_hand_ladder():
    """bench.py's hand ladder, [[ph, pw, radius, capacity], ...], from
    its ``RasterConfig(buckets=(BucketSpec(...), ...))``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "RasterConfig"):
            buckets = next(k.value for k in node.keywords
                           if k.arg == "buckets")
            return [[ast.literal_eval(a) for a in c.args[:4]]
                    for c in buckets.elts]
    raise AssertionError("bench.py builds no RasterConfig")


def _run(monkeypatch, capsys, **env):
    for name in bench.KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in {**TINY, **env}.items():
        monkeypatch.setenv(name, value)
    rec = bench.main()
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    assert out.splitlines()[-1] == line
    assert json.loads(line) == rec
    return rec, out


def test_bench_line_holds_the_ports_keys(monkeypatch, capsys):
    rec, out = _run(monkeypatch, capsys)
    assert set(rec) == KEYS
    assert rec["value"] > 0 and rec["steady_state"] > 0
    assert rec["unit"] == "images/s"
    assert rec["ladder"] == _jax_hand_ladder()
    assert rec["modal_blur"] is True and rec["cone_downsample"] == 4
    assert rec["fields_dtype"] == "float32"
    assert rec["device"] == "cpu"
    # The CPU runs every kernel's plain version: no launch.
    assert rec["launches"] == {"raster": 0, "blur": 0}
    assert rec["metric"].startswith(
        "KITTI 1242x375 fresh-frame render throughput @10mm/hr (batch=2, ")
    assert rec["metric"].endswith(", device=cpu)")
    assert "# device: cpu" in out
    assert out.count("runs (images/s):") == 2


def test_bench_fitted_ladder_and_modal_knob(monkeypatch, capsys):
    rec, out = _run(monkeypatch, capsys, FITTED="1", MODAL="0")
    w = bench.workload("cpu", (96, 256), 2, 64, modal_blur=False)
    want = bench.ladder(bench.fitted(w).cfg)
    assert rec["ladder"] == want != _jax_hand_ladder()
    assert f"# fitted ladder: {want}" in out
    assert rec["modal_blur"] is False
    assert set(rec) == KEYS and rec["value"] > 0


def test_bench_bf16_field_planes(monkeypatch, capsys):
    """FIELDS_DTYPE=bfloat16 (the JAX bench's knob): the render's planes
    are bfloat16, the guards pass and the line says so."""
    dtypes = []
    real = tframe.fused_field_planes

    def planes(*args, **kw):
        out = real(*args, **kw)
        dtypes.append(out[2].dtype)
        return out

    monkeypatch.setattr(tframe, "fused_field_planes", planes)
    rec, _ = _run(monkeypatch, capsys, FIELDS_DTYPE="bfloat16")
    assert set(rec) == KEYS and rec["fields_dtype"] == "bfloat16"
    assert rec["value"] > 0 and rec["steady_state"] > 0
    assert rec["launches"] == {"raster": 0, "blur": 0}
    assert dtypes and set(dtypes) == {torch.bfloat16}


def test_bench_bf16_refuses_without_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run on it")
    for name in bench.KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("FIELDS_DTYPE", "bfloat16")
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main()
    assert capsys.readouterr().out == ""


def _with_output(monkeypatch, change):
    real = tframe.render_frames

    def render(*args, **kw):
        return change(real(*args, **kw))

    monkeypatch.setattr(tframe, "render_frames", render)


@pytest.mark.parametrize("change,match", [
    (lambda out: dataclasses.replace(
        out, rain_mask=torch.zeros_like(out.rain_mask)), "no rain"),
    (lambda out: dataclasses.replace(
        out, overflow=out.overflow + 1), "overflowed"),
])
def test_bench_guards_raise(monkeypatch, capsys, change, match):
    _with_output(monkeypatch, change)
    with pytest.raises(AssertionError, match=match):
        _run(monkeypatch, capsys)
    assert "{" not in capsys.readouterr().out


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run on it")
    env = {k: v for k, v in os.environ.items() if k not in bench.KNOBS}
    proc = subprocess.run(
        [sys.executable, "-m", "raintpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**env, **{k: v for k, v in TINY.items() if k != "DEVICE"}})
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")], proc.stdout


def test_workload_is_the_jax_benchs():
    """bench.py's inputs: KITTI's camera, the simulation at capacity
    512, frames and depth maps from RandomState(0), the procedural
    texture bank and its bin edges."""
    w = bench.workload("cpu", (96, 256), 2, 64)
    settings = jcam.RenderSettings(camera=jcam.CameraSettings())
    assert (dataclasses.asdict(w.cfg.settings.camera)
            == dataclasses.asdict(settings.camera))
    want_sim = jsim.SimConfig.from_settings(settings, capacity=512)
    got_sim = tsim.SimConfig.from_settings(w.cfg.settings,
                                           capacity=bench.SIM_CAPACITY)
    assert dataclasses.asdict(got_sim) == dataclasses.asdict(want_sim)
    assert w.cfg.image_hw == (96, 256) and w.cfg.fallrate == 10.0
    assert w.cfg.cone_downsample == 4 and w.cfg.env_fold
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        w.bg.numpy(), rng.rand(2, 96, 256, 3).astype(np.float32))
    np.testing.assert_array_equal(
        w.depth.numpy(), (rng.rand(2, 96, 256) * 60 + 3).astype(np.float32))
    db = jtex.procedural_streak_database()
    np.testing.assert_array_equal(w.edges.numpy(), np.asarray(db.bin_edges))
    np.testing.assert_allclose(w.bank.raw.numpy(),
                               np.asarray(jtex.texture_bank(db).raw),
                               atol=1e-6)
    counts = w.drops.count()
    assert tuple(w.drops.valid.shape) == (2, 64)
    assert int(counts.min()) > 0
