"""The kernel counts and the trace arithmetic: a count follows the
cell's inputs and not the program's ladder, a count of a lone drop is
the window worked out by hand, and the traced window's busy time, gaps
and rooflines are the union arithmetic they claim."""

import dataclasses

import numpy as np
import pytest
import torch

from rainbench import harness, inputs, roofline, spec
from rainbench import trace as trace_view
from rainbench.tests.conftest import tiny
from raintpu_torch.ops import rasterize

SEED = 2 ** 35 + 17


def _counts(monkeypatch, ladder):
    """The counts of the traced steps of a run whose program took
    ``ladder`` (None: the fitted one)."""
    if ladder is not None:
        monkeypatch.setattr(rasterize, "fit_raster_config",
                            lambda *a, **k: ladder)
    cell = tiny("kitti-200mm")
    pool, prog, _ = harness.setup(cell, SEED, "cpu")
    got = [b.ph for b in prog.cfg.raster.buckets]
    steps = harness.traced_inputs(
        cell, pool, [prog.drops_of(i % pool.batches) for i in range(3)])
    return got, [spec.count(k).count(s) for s in steps
                 for k in ("fused_raster", "separable_blur")]


def test_counts_do_not_follow_the_ladder(monkeypatch):
    fitted, a = _counts(monkeypatch, None)
    hand = rasterize.RasterConfig.default(4096)
    other, b = _counts(monkeypatch, hand)
    assert fitted != other
    assert a == b and a[0][0] > 0


def _lone_drop(x, y, iw, dz):
    d = {k: torch.zeros((1, 1) + s) for k, s in (
        ("ip1", (2,)), ("ip2", (2,)), ("iw1", ()), ("iw2", ()),
        ("wp1", (3,)), ("wp2", (3,)), ("ratio", ()))}
    d["ip1"][0, 0] = torch.tensor([x, y])
    d["ip2"][0, 0] = torch.tensor([x, y + 20.0])
    d["iw1"][0, 0] = d["iw2"][0, 0] = iw
    d["wp1"][0, 0, 2] = d["wp2"][0, 0, 2] = dz
    d["max_width"] = torch.full((1, 1), int(iw), dtype=torch.int32)
    d["length"] = torch.full((1, 1), 20, dtype=torch.int32)
    d["drop_type"] = torch.full((1, 1), inputs.TYPE_SMALL, dtype=torch.int32)
    d["valid"] = torch.ones((1, 1), dtype=torch.bool)
    return d


def test_raster_count_of_a_lone_drop():
    cfg = spec.config("kitti")
    step = harness.StepInputs(drops=_lone_drop(100.0, 50.0, 2.0, 6.0),
                              settings=cfg["settings"], image_hw=(375, 1242),
                              tex_hw=inputs.CANVAS)
    mod = spec.count("fused_raster")
    ops, nbytes = mod.count(step)
    # In focus (6 m): no spill. A Small drop's content is max(|dx|,
    # max_width + 2) = 4 wide and max(|dy|, 2) = 20 high.
    assert ops == 4 * 20 * mod.OPS_PER_PX
    assert nbytes == 5 * 375 * 1242 * 4 + mod.DROP_BYTES
    # At the frame's corner the window is cut to the frame.
    step = dataclasses.replace(step, drops=_lone_drop(1240.0, 370.0, 2.0,
                                                      6.0))
    assert mod.count(step)[0] == 2 * 5 * mod.OPS_PER_PX


def test_blur_count():
    step = harness.StepInputs(drops={"valid": torch.ones(3, 7,
                                                         dtype=torch.bool)},
                              settings={}, image_hw=(10, 20), tex_hw=(1, 1))
    ops, nbytes = spec.count("separable_blur").count(step)
    assert nbytes == 2 * 4 * 3 * 200 * 4
    assert ops == 4 * 3 * 200 * 4 * 25


class _Prof:
    """A stand-in profile: events with a device type and a range."""

    def __init__(self, evs):
        self._evs = evs

    def events(self):
        return self._evs


def _ev(name, start, end, device):
    from torch.autograd import DeviceType

    return type("E", (), dict(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        cpu_parent=None,
        time_range=type("T", (), dict(start=start, end=end))()))()


def test_trace_view_arithmetic():
    prof = _Prof([_ev("aten::add", 0, 100, False),
                  _ev("aten::mul", 100, 400, False),
                  _ev("fused_raster_kernel<4, float>", 10, 30, True),
                  _ev("k2", 20, 50, True),
                  _ev("separable_blur_kernel", 200, 260, True),
                  _ev("k3", 300, 310, True)])
    v = trace_view.view(prof, steps=2)
    assert v.window_s == pytest.approx(400e-6)
    assert v.busy_s == pytest.approx((40 + 60 + 10) * 1e-6)
    assert v.op_seconds("fused_raster_kernel") == pytest.approx(20e-6)
    assert [n for n, _ in v.top_ops()][:1] == ["separable_blur_kernel"]
    gaps = v.idle_gaps()
    assert [g[0] for g in gaps] == ["aten::mul", "aten::mul"]
    assert gaps[0][1] == pytest.approx(150e-6)
    # A window the host clock timed stands for the events' span.
    timed = trace_view.view(prof, steps=2, window_s=500e-6)
    assert timed.window_s == 500e-6 and timed.busy_s == v.busy_s
    run = harness.Run(cell=None, device_name="NVIDIA H100 80GB HBM3",
                      setup_s=0, step_s=[9e-4] * 4 + [200e-6, 240e-6],
                      window_s=0, frames=0, view=v, profiled_steps=4)
    # 110 us busy over the 2 traced steps; untraced steps of 220 us.
    assert spec.reader("device.idle_share").read(run) == pytest.approx(
        100 * (1 - 55 / 220))
    assert spec.reader("render.device_ops_per_step").read(run) == 2.0
    run.traced = [harness.StepInputs(
        drops={"valid": torch.ones(1, 1, dtype=torch.bool)}, settings={},
        image_hw=(100, 100), tex_hw=(1, 1))]
    assert roofline.share(run, "separable_blur") is None  # none issued
    run.issued = {"separable_blur": 1}
    share = roofline.share(run, "separable_blur")
    assert share == pytest.approx(100 * (2 * 4 * 1e4 * 4 / 3.35e12) / 60e-6)
    # A launch the profile lost: the bound of the one it kept.
    run.issued = {"separable_blur": 2}
    assert roofline.share(run, "separable_blur") == pytest.approx(share / 2)
    run.device_name = "some other card"
    assert roofline.share(run, "separable_blur") is None


def test_breakdown_lists_at_most_ten():
    prof = _Prof([_ev(f"k{i}", 10 * i, 10 * i + 5, True) for i in range(30)])
    v = trace_view.view(prof, 1)
    assert len(v.top_ops()) == 10 and len(v.idle_gaps()) == 10
    assert all(np.isclose(s, 5e-6) for _, s in v.idle_gaps())


def test_step_percentile_and_rate():
    run = harness.Run(cell=None, device_name="cpu", setup_s=3.5,
                      step_s=[0.01] * 95 + [0.05] * 5, window_s=2.0,
                      frames=200, view=None)
    assert spec.reader("images_per_s").read(run) == 100.0
    assert spec.reader("step_ms_p95").read(run) == pytest.approx(12.0)
    assert spec.reader("setup_s").read(run) == 3.5
    assert spec.reader("device.idle_share").read(run) is None


def test_online_rate_reads_the_untraced_steps():
    cell = type("C", (), {"batch": 48})()
    run = harness.Run(cell=cell, device_name="cpu", setup_s=1.0,
                      step_s=[0.5] * 4 + [0.2] * 10, window_s=4.0,
                      frames=48 * 14, view=None, profiled_steps=4)
    assert spec.reader("online.images_per_s").read(run) == pytest.approx(
        48 / 0.2)
    run.step_s = run.step_s[:4]
    assert spec.reader("online.images_per_s").read(run) is None


SPLIT = sorted(m["name"] for m in spec.benchmark()["per_layer"]
               if m["name"].endswith(".online"))


@pytest.mark.parametrize("name", SPLIT)
def test_online_metric_reads_as_its_base(name):
    prof = _Prof([_ev("aten::add", 0, 100, False),
                  _ev("separable_blur_kernel", 200, 260, True),
                  _ev("k3", 300, 310, True)])
    run = harness.Run(cell=None, device_name="NVIDIA H100 80GB HBM3",
                      setup_s=0, step_s=[9e-4] * 4 + [200e-6, 240e-6],
                      window_s=0, frames=0, view=trace_view.view(prof, 2),
                      profiled_steps=4, issued={"separable_blur": 1,
                                                "fused_raster": 0})
    run.traced = [harness.StepInputs(
        drops={"valid": torch.ones(1, 1, dtype=torch.bool)}, settings={},
        image_hw=(100, 100), tex_hw=(1, 1))]
    base = name[:-len(".online")]
    assert spec.reader(name).read(run) == spec.reader(base).read(run)
