"""The reader of render.prep.replay_share on hand-built runs: the share
of the window's untraced steps whose ring holds render.prep.replay;
nothing on the CPU or from a program without the prep's graph."""

import collections

import pytest

from rainbench import spec

READ = spec.reader("render.prep.replay_share").read


def _run(device_name, profiled, untraced):
    from rainbench import harness

    return harness.Run(cell=spec.cell("kitti-10mm"), device_name=device_name,
                       setup_s=1.0, step_s=[0.05] * (profiled + untraced),
                       window_s=1.0, frames=48, profiled_steps=profiled)


def _ring(monkeypatch, replayed):
    """12 steps of render.prep, with render.prep.replay inside it in the
    steps ``replayed``."""
    from raintpu_torch.utils import profiling

    ring = collections.deque(maxlen=profiling.RING_SPANS)
    for step in range(1, 13):
        if step in replayed:
            ring.append(("render.prep.replay", "render.prep", step, 0,
                         200_000))
        ring.append(("render.prep", None, step, 0, 1_000_000))
    monkeypatch.setattr(profiling, "RING", ring)


@pytest.mark.parametrize("replayed, want", [
    (range(1, 13), 100.0),      # every step replays
    (range(1, 3), 0.0),         # only the profiled steps
    ((8, 10, 12), 60.0),        # 3 of the untraced steps 8-12
    ((), 0.0),                  # eager throughout
])
def test_reads_the_untraced_share(monkeypatch, replayed, want):
    _ring(monkeypatch, replayed)
    # 4 profiled steps, then 5 untraced ones: the ring's steps 8-12.
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 5)) == pytest.approx(want)


def test_reads_nothing_on_the_cpu_or_without_the_graph(monkeypatch):
    from raintpu_torch.render import frame

    _ring(monkeypatch, range(1, 13))
    assert READ(_run("cpu", 4, 5)) is None
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 0)) is None
    # A program whose prep has no graph (one that predates it).
    monkeypatch.delattr(frame, "PREP_GRAPHS")
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 5)) is None
