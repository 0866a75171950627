"""Every configuration, traffic mix, limit, metric and kernel count that
BENCHMARK.json names is a file of its own under rainbench/, found and
loaded by name, and BENCHMARK.json keeps to the shape the harness reads.
"""

import json
import re

import pytest

from rainbench import harness, inputs, spec
from rainbench.tests.conftest import CELLS

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rainbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"rainbench/configs/{entry['name']}.json"
    cfg = spec.config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    for key in ("cam_WH", "cam_CCD_WH", "cam_focal", "cam_f_number",
                "cam_exposure", "cam_gain", "cam_CCD_pixsize"):
        assert key in cfg["settings"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    for key in ("fallrate_mm_hr", "batch", "pool_batches", "save_envmap",
                "depth_m", "check_frames_per_batch", "reference_block_frames",
                "trace_steps"):
        assert key in cell.traffic
    held = cell.limits["numbers"]
    assert {"mask_max", "image_mean", "overflow"} <= set(held)
    assert ("envmap_max" in held) == bool(cell.traffic["save_envmap"])
    assert held["overflow"]["limit"] == 0
    if inputs.drop_source(cell.traffic) == "online":
        assert int(cell.traffic["sim_capacity"]) > 0
        for name_ in ("truncated", "sim_mismatch", "picks_mismatch"):
            assert held[name_]["limit"] == 0
    # The host issues an online cell's step, and its rate moves by more
    # than a bound can hold: there it is the per-layer
    # online.images_per_s.
    rate = {"images_per_s"} if inputs.drop_source(cell.traffic) == "pool" \
        else set()
    assert {m["name"] for m in cell.end_to_end} == {
        "step_ms_p95", "setup_s"} | rate
    assert len(cell.per_layer) >= 1


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    for w in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in spec.cell(w).end_to_end}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"])
    assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(metric["name"]).read)
    for w in metric.get("workloads", []):
        assert w in CELLS


@pytest.mark.parametrize("kernel", ["fused_raster", "separable_blur"])
def test_kernel_count(kernel):
    mod = spec.count(kernel)
    assert mod.NAME.endswith("_kernel") and callable(mod.count)
    assert kernel in harness.launch_counts()


def test_bounds_and_names():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert len(json.dumps(BENCH)) < 64 * 1024
