"""A run with the timed path broken underneath comes out not correct,
for each fault a render cell can have: a step that hands back an
earlier step's outputs (its state unchanged), half of the batch left
out, and an answer altered where it is produced: one drop of one frame
lost from the rain mask and the image, or drops lost to rungs cut below
their occupancy (the drop accounting). The cells take one chip, so
there is no exchange between chips to leave out."""

import dataclasses
import time

import pytest
import torch

from rainbench import harness
from rainbench.tests.conftest import tiny
from raintpu_torch.render import frame

SEED = 2 ** 36 + 5


def _stale(real):
    last = {}

    def render(bg, *a, **kw):
        out = last.get("out")
        last["out"] = real(bg, *a, **kw)
        return out if out is not None else last["out"]
    return render


def _half(real):
    def render(bg, depth, drops, *a, **kw):
        n = bg.shape[0] // 2
        out = real(bg[:n], depth[:n], drops.map(lambda t: t[:n]), *a,
                   **{k: (v[:n] if isinstance(v, torch.Tensor) else v)
                      for k, v in kw.items()})
        pad = n if bg.shape[0] % 2 == 0 else n + 1

        def fill(t):
            return None if t is None else torch.cat([t, t[:pad] * 0])
        return frame.FrameOutput(
            **{f.name: fill(getattr(out, f.name))
               for f in dataclasses.fields(out)})
    return render


def _altered(real):
    def render(bg, depth, drops, *a, **kw):
        valid = drops.valid.clone()
        first = int(valid[0].nonzero()[0])
        valid[0, first] = False
        return real(bg, depth, dataclasses.replace(drops, valid=valid), *a,
                    **kw)
    return render


def _short(real):
    def render(bg, depth, drops, textures, edges, cfg, *a, **kw):
        rungs = tuple(dataclasses.replace(b, capacity=max(1, b.capacity // 4))
                      for b in cfg.raster.buckets)
        cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
            cfg.raster, buckets=rungs))
        return real(bg, depth, drops, textures, edges, cfg, *a, **kw)
    return render


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _short],
                         ids=["stale", "half", "altered", "short"])
@pytest.mark.parametrize("name", ["kitti-10mm", "nuscenes-100mm",
                                  "kitti-online-25mm",
                                  "cityscapes-25mm-envmap"])
def test_fault_is_not_correct(monkeypatch, fault, name):
    cell = tiny(name, batch=4 if fault is _half else 2)
    monkeypatch.setattr(frame, "render_frames", fault(frame.render_frames))
    _not_correct(cell)


def _not_correct(cell):
    result, checks = harness.run(cell, SEED, 0.3, False, "cpu",
                                 time.perf_counter())
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in checks.values())


def _moved(real):
    """One drop of each batch's first frame moved a pixel as it is
    simulated."""
    def simulate(*a, **kw):
        out = real(*a, **kw)
        first = int(out.valid[0].nonzero()[0])
        out.ip1[0, first, 0] += 1.0
        return out
    return simulate


def _repicked(real):
    def select(drops, edges, gen=None):
        return (real(drops, edges, gen) + 1) % 50
    return select


def _cut(real):
    """Compaction one slot short of the batch's largest valid count:
    a drop lost."""
    def compact(drops, capacity):
        return real(drops, int(drops.count().max()) - 1)
    return compact


@pytest.mark.parametrize("fault", ["moved", "repicked", "cut", "truncated"])
def test_online_source_fault_is_not_correct(monkeypatch, fault):
    """The online source's faults the reference cannot see, since it
    renders the drops and picks the step made: a drop altered where it
    is simulated, a pick altered where it is drawn, drops lost to the
    compaction, and drops lost to the simulation capacity."""
    from raintpu_torch.ops import rasterize
    from raintpu_torch.particles import schema
    from raintpu_torch.physics import simulator

    cell = tiny("kitti-online-25mm")
    if fault == "moved":
        monkeypatch.setattr(simulator, "simulate_frames_keyed",
                            _moved(simulator.simulate_frames_keyed))
    elif fault == "repicked":
        monkeypatch.setattr(rasterize, "select_textures",
                            _repicked(rasterize.select_textures))
    elif fault == "cut":
        monkeypatch.setattr(schema, "compact_drop_batch",
                            _cut(schema.compact_drop_batch))
    else:
        cell.traffic["sim_capacity"] = 64
    _not_correct(cell)
