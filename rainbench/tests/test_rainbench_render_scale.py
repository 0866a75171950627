"""A configuration that renders at a scale (Cityscapes: render_scale 2):
its settings are the dataset plugin's verbatim, the pool is made at the
rendered size, and the benchmark's copy of the simulator's law draws
what the program's simulator draws there, drop for drop."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from rainbench import harness, inputs, spec
from rainbench.tests.conftest import TINY_HW, tiny

SEED = 2 ** 34 + 777
FRAMES = (0, 1, 57)


def _ends_in_frame(drops: dict, w: int, h: int) -> bool:
    """Every valid drop has an end inside the rendered (w, h) frame."""
    def inside(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < w)
                & (p[..., 1] >= 0) & (p[..., 1] < h))
    seen = inside(drops["ip1"]) | inside(drops["ip2"])
    return bool(seen[drops["valid"]].all())


def test_settings_are_the_plugins():
    from raintpu_torch.data.datasets import cityscapes

    want = cityscapes.settings()
    steps = want.pop("sequences")["leftImg8bit"]["sim_steps"]["cam_motion"]
    cfg = spec.config("cityscapes")
    assert cfg["settings"] == want
    assert np.array_equal(inputs.speed_schedule(cfg), steps)
    cam = inputs.Camera.from_settings(cfg["settings"])
    assert cam.render_scale == 2 and cam.render_wh == (1020, 508)


@pytest.mark.parametrize("config", ["kitti", "nuscenes", "cityscapes"])
def test_law_copy_draws_the_programs_drops(config):
    """inputs.simulate against simulate_frames_keyed, frame by frame on
    the same frame generators, at the configuration's full size and the
    job's exposure."""
    from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                                 schedule_from_settings,
                                                 simulate_frames_keyed)
    from raintpu_torch.render.camera import settings_from_dict

    s = spec.config(config)["settings"]
    cam = inputs.Camera.from_settings(s)
    rate = 25.0
    cap = inputs.simulation_capacity(cam, rate)
    sim = SimConfig.from_settings(settings_from_dict(s), capacity=cap)
    assert sim.render_scale == cam.render_scale
    fall, _, expo, focal = schedule_from_settings(
        settings_from_dict(s), rate, n_frames=max(FRAMES) + 1)
    speeds = torch.tensor([13.9, 0.0, 7.5])
    cols = [torch.as_tensor(a[list(FRAMES)]) for a in (fall, expo, focal)]
    assert torch.equal(cols[1], inputs.job_exposure_s(s, len(FRAMES), "cpu"))
    got = simulate_frames_keyed(
        [frame_generator(SEED, f, "cpu") for f in FRAMES], sim, cols[0],
        speeds, cols[1], cols[2])
    w, h = cam.render_wh
    for b, f in enumerate(FRAMES):
        fields, count = inputs.simulate(
            inputs.generator(SEED, f, "cpu"), cam, cap,
            torch.full((1,), rate), speeds[b:b + 1], cols[1][b:b + 1])
        assert int(count) <= cap
        for name, want in fields.items():
            assert torch.equal(getattr(got, name)[b], want[0]), (f, name)
        assert int(fields["valid"].sum()) > 0
        assert _ends_in_frame({k: v[0] for k, v in fields.items()}, w, h)


def test_pool_is_made_at_the_rendered_size():
    cell = tiny("cityscapes-25mm-envmap")
    assert cell.config["settings"]["cam_WH"] == [2 * TINY_HW[1],
                                                 2 * TINY_HW[0]]
    pool = inputs.make_pool(cell.config, cell.traffic, SEED, "cpu")
    assert tuple(pool.bg.shape[-3:-1]) == TINY_HW
    assert tuple(pool.depth.shape[-2:]) == TINY_HW
    assert int(pool.drops["valid"].sum()) > 0
    assert _ends_in_frame(pool.drops, TINY_HW[1], TINY_HW[0])


def test_online_cell_at_render_scale_is_correct():
    """The online cell on the Cityscapes configuration at a CPU size."""
    cell = tiny("kitti-online-25mm", config="cityscapes")
    result, checks = harness.run(cell, SEED, 0.3, False, "cpu",
                                 time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    for name in ("sim_mismatch", "picks_mismatch", "truncated"):
        assert checks[name]["value"] == 0, name


def test_online_cell_without_the_division_is_not_correct(monkeypatch):
    """The program's simulator with its render_scale taken out: drops
    projected at the camera's size onto the half-size frame."""
    from raintpu_torch.physics import simulator

    real = simulator.SimConfig.from_settings

    def unscaled(settings, capacity=4096):
        return dataclasses.replace(real(settings, capacity),
                                   render_scale=1.0)

    monkeypatch.setattr(simulator.SimConfig, "from_settings",
                        staticmethod(unscaled))
    cell = tiny("kitti-online-25mm", config="cityscapes")
    result, checks = harness.run(cell, SEED, 0.3, False, "cpu",
                                 time.perf_counter())
    assert result["correct"] is False and result["failed"] > 0
    assert checks["sim_mismatch"]["value"] > 0
