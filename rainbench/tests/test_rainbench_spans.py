"""The five host-ms readers (``metrics/render.*.host_ms.py``) on
hand-built runs: each reads the program's span ring, over exactly the
window's untraced steps, and reads nothing on the CPU or from a program
without the ring."""

import collections
import statistics

import pytest

from rainbench import harness, spec

STAGES = ("render.fog", "render.envmap", "render.prep", "render.raster",
          "render.finalize")


def _run(device_name, profiled, untraced):
    return harness.Run(cell=spec.cell("kitti-10mm"), device_name=device_name,
                       setup_s=1.0, step_s=[0.05] * (profiled + untraced),
                       window_s=1.0, frames=48, profiled_steps=profiled)


@pytest.fixture
def ring(monkeypatch):
    """The program's ring, filled with 12 steps: in step i each stage
    takes i ms, but render.raster, 100 + i."""
    from raintpu_torch.utils import profiling

    fresh = collections.deque(maxlen=profiling.RING_SPANS)
    for step in range(1, 13):
        for name in STAGES:
            ms = step + (100 if name == "render.raster" else 0)
            fresh.append((name, None, step, 0, int(ms * 1e6)))
    monkeypatch.setattr(profiling, "RING", fresh)
    return fresh


@pytest.mark.parametrize("name", STAGES)
def test_reader_takes_the_untraced_steps(name, ring):
    read = spec.reader(name + ".host_ms").read
    # 4 profiled steps, then 5 untraced ones: the ring's steps 8-12.
    got = read(_run("NVIDIA H100 80GB HBM3", 4, 5))
    want = statistics.median(
        s + (100 if name == "render.raster" else 0) for s in range(8, 13))
    assert got == pytest.approx(want)
    assert read(_run("NVIDIA H100 80GB HBM3", 4, 2)) == pytest.approx(
        want + 1.5)
    assert read(_run("cpu", 4, 5)) is None
    assert read(_run("NVIDIA H100 80GB HBM3", 4, 0)) is None


@pytest.mark.parametrize("name", STAGES)
def test_reader_reads_nothing_without_spans(name, monkeypatch):
    from raintpu_torch.utils import profiling

    read = spec.reader(name + ".host_ms").read
    monkeypatch.setattr(profiling, "RING", collections.deque(maxlen=8))
    assert read(_run("NVIDIA H100 80GB HBM3", 4, 5)) is None
    # A program with no ring at all (one that predates the spans).
    monkeypatch.delattr(profiling, "stage_ms")
    assert read(_run("NVIDIA H100 80GB HBM3", 4, 5)) is None
