"""Each cell run end to end at a CPU size: the result line's contract,
the traced run's per-layer line, and the refusals (no card; a checkout
with the benchmark alone)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from rainbench import harness, run, spec
from rainbench.tests.conftest import CELLS, tiny

SEED = 2 ** 33 + 12345


def _run(name, trace=False, seed=SEED):
    result, checks = harness.run(tiny(name), seed, 0.5, trace, "cpu",
                                 time.perf_counter())
    result["checks"] = checks
    return result


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_cpu(name):
    result = _run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "build", "card", "checks"]
    assert result["build"]["compiled"] == []
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 2 and result["attempted"] % 2 == 0
    assert set(result["metrics"]) == {
        m["name"] for m in spec.cell(name).end_to_end}
    assert {"step_ms_p95", "setup_s"} <= set(result["metrics"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["metrics"]["step_ms_p95"]["unit"] == "ms"
    dev = result["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    for name_, c in result["checks"].items():
        assert c["value"] <= c["limit"], name_
    json.dumps(result)


def test_traced_run_reports_per_layer_shape():
    result = _run("kitti-10mm", trace=True)
    assert result["correct"] is True
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"
    assert result["trace"]["step_ms_untraced"] > 0
    # No device on the CPU: the readers find nothing and say nothing.
    assert result["metrics"] == {}


def test_same_seed_same_inputs():
    cell = tiny("kitti-200mm")
    from rainbench import inputs

    a = inputs.make_pool(cell.config, cell.traffic, SEED, "cpu")
    b = inputs.make_pool(cell.config, cell.traffic, SEED, "cpu")
    c = inputs.make_pool(cell.config, cell.traffic, SEED + 1, "cpu")
    assert torch.equal(a.bg, b.bg) and torch.equal(a.tex_idx, b.tex_idx)
    assert all(torch.equal(a.drops[k], b.drops[k]) for k in a.drops)
    assert not torch.equal(a.bg, c.bg)
    # Every seed renders the same set of camera speeds.
    assert torch.equal(a.speeds_mps.flatten().sort().values,
                       c.speeds_mps.flatten().sort().values)
    assert int(a.drops["valid"].sum()) > 0


def test_main_refuses_without_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kitti-10mm", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_benchmark_alone_is_refused(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "rainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-m", "rainbench.run", "--workload",
                        "kitti-10mm", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
