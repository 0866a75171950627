"""The reader of online.sim.replay_share on hand-built runs: the share of
the window's untraced steps whose online.drops span holds a sim.replay
span by time; nothing on the CPU or from a program without the
simulation's graph."""

import collections

import pytest

from rainbench import spec

READ = spec.reader("online.sim.replay_share").read
MS = 1_000_000


def _run(device_name, profiled, untraced):
    from rainbench import harness

    return harness.Run(cell=spec.cell("kitti-online-25mm"),
                       device_name=device_name, setup_s=1.0,
                       step_s=[0.05] * (profiled + untraced), window_s=1.0,
                       frames=48, profiled_steps=profiled)


def _ring(monkeypatch, replayed, outside=()):
    """12 steps, step i from i * 10 ms: online.drops over its first 6 ms
    (stamped with the step it feeds, as the harness stamps it), then
    render.prep; sim.replay inside online.drops in the steps
    ``replayed`` (stamped with the step before, as a span opened there
    is), and, in the steps ``outside``, after it, inside render.prep."""
    from raintpu_torch.utils import profiling

    ring = collections.deque(maxlen=profiling.RING_SPANS)
    for step in range(1, 13):
        t = step * 10 * MS
        if step in replayed:
            ring.append(("sim.replay", "online.drops", step - 1,
                         t + 1 * MS, t + 3 * MS))
        ring.append(("online.drops", None, step, t, t + 6 * MS))
        if step in outside:
            ring.append(("sim.replay", "render.prep", step,
                         t + 7 * MS, t + 8 * MS))
        ring.append(("render.prep", None, step, t + 6 * MS, t + 9 * MS))
    monkeypatch.setattr(profiling, "RING", ring)


@pytest.mark.parametrize("replayed, outside, want", [
    (range(1, 13), (), 100.0),      # every step replays
    (range(1, 3), (), 0.0),         # only the profiled steps
    ((8, 10, 12), (), 60.0),        # 3 of the untraced steps 8-12
    ((), range(1, 13), 0.0),        # a replay, but not in the drop source
    ((9,), (8, 10), 20.0),
    ((), (), 0.0),                  # eager throughout
])
def test_reads_the_untraced_share(monkeypatch, replayed, outside, want):
    _ring(monkeypatch, replayed, outside)
    # 4 profiled steps, then 5 untraced ones: the ring's steps 8-12.
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 5)) == pytest.approx(want)


def test_reads_nothing_on_the_cpu_or_without_the_graph(monkeypatch):
    from raintpu_torch.physics import simulator

    _ring(monkeypatch, range(1, 13))
    assert READ(_run("cpu", 4, 5)) is None
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 0)) is None
    # A program whose simulation has no graph (one that predates it).
    monkeypatch.delattr(simulator, "SIM_GRAPHS")
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 5)) is None


def test_reads_nothing_without_the_drop_source(monkeypatch):
    from raintpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "RING", collections.deque(maxlen=8))
    assert READ(_run("NVIDIA H100 80GB HBM3", 4, 5)) is None
