"""The drop source a traffic mix names: under "online" the harness's
step makes its drops and picks as the program's online job does, and
under "pool" (the default) the inputs are those the benchmark made
before it had a second source."""

import hashlib
import time

import numpy as np
import pytest
import torch

from rainbench import harness, inputs
from rainbench.tests.conftest import tiny

SEED = 2 ** 33 + 12345


def _job(cell, pool):
    """The program's online job on the CPU with the cell's camera, fall
    rate and simulation capacity, and the pool's camera speeds in place
    of the dataset plugin's per-sequence schedule."""
    from raintpu_torch.physics.simulator import (SimConfig,
                                                 schedule_from_settings)
    from raintpu_torch.render.camera import settings_from_dict
    from raintpu_torch.render.online import OnlineRenderJob
    from raintpu_torch.render.pipeline import JobSpec

    t = cell.traffic
    rate = float(t["fallrate_mm_hr"])
    job = OnlineRenderJob(JobSpec(
        dataset="kitti", sequences=[], images={}, depth={}, calib={},
        particles={}, weather=[{"weather": "rain", "fallrate": rate}],
        settings=cell.config["settings"], output_root="unused",
        drop_capacity=int(t["sim_capacity"]), seed=SEED, device="cpu"))
    rs = settings_from_dict(cell.config["settings"])
    job._sim_cfg = SimConfig.from_settings(rs, capacity=job.spec.drop_capacity)
    fall, _, expo, focal = schedule_from_settings(
        rs, rate, n_frames=pool.speeds_mps.numel())
    job._sched_fall, job._sched_expo, job._sched_focal = fall, expo, focal
    job._sched_speed = pool.speeds_mps.flatten().numpy()
    job._sim_seed = SEED
    job._trunc_seen = set()
    job._render_cap = None
    job._export_frames = None
    return job


def test_online_drops_equal_the_jobs():
    cell = tiny("kitti-online-25mm", batch=3)
    pool, prog, _ = harness.setup(cell, SEED, "cpu")
    job = _job(cell, pool)
    frames = [inputs.online_frames(cell.traffic, j)
              for j in range(pool.batches)]
    for f in frames:            # the job's render capacity settles
        job._drops_for_frames(f)
    assert job._render_cap == prog.source.render_cap
    for j, f in enumerate(frames):
        drops, picks = prog.used[j]
        want = job._drops_for_frames(f)
        for name, t in harness._fields(want).items():
            assert torch.equal(getattr(drops, name), t), name
        want_picks, noise = job._frame_draws(want, prog.edges, f)
        assert noise is None and torch.equal(picks, want_picks)
    assert int(drops.valid.sum()) > 0
    assert job._truncated_total == 0 and prog.truncated() == 0


def _digest(pool) -> str:
    h = hashlib.sha256()
    for t in [pool.bg, pool.depth, pool.tex_idx, pool.speeds_mps] + [
            pool.drops[k] for k in sorted(pool.drops)]:
        h.update(t.contiguous().numpy().tobytes())
    h.update(pool.textures.tobytes())
    h.update(pool.bin_edges.tobytes())
    return h.hexdigest()


# The pools of the pool cells (this seed, the CPU size), by their
# sha256: the first four as the benchmark made them before the online
# source, nuscenes-10mm's as it was added, and Cityscapes' at its render
# scale.
POOL_DIGESTS = {
    "kitti-10mm": "5bc6c09dcd4b567b7adebb60c9996c65"
                  "9735efab42b5be7cf2dd54a0717b1cbd",
    "nuscenes-100mm": "4784cfe0b0110c514818739e9af917eb"
                      "ba815e8cfadd94eb6e710baf7dba33dd",
    "kitti-10mm-envmap": "5bc6c09dcd4b567b7adebb60c9996c65"
                         "9735efab42b5be7cf2dd54a0717b1cbd",
    "kitti-200mm": "48cd5a917eef85e80a45fad8ab840e35"
                   "9d24318fd6068872c9112a2eb668bfae",
    "nuscenes-10mm": "ac292eadff4cc882fd253d11e25ff9fc"
                     "6e2375ffb73a6cea33df771da8f13bdb",
    "cityscapes-25mm-envmap": "a82a0394dc24fb2f762430c7a6c231d7"
                              "9cda9249379c35d3dc5e550a6f02159d",
}


@pytest.mark.parametrize("name", sorted(POOL_DIGESTS))
def test_pool_inputs_are_unchanged(name):
    cell = tiny(name)
    assert inputs.drop_source(cell.traffic) == "pool"
    pool = inputs.make_pool(cell.config, cell.traffic, SEED, "cpu")
    assert _digest(pool) == POOL_DIGESTS[name]


def test_online_pool_holds_no_drops():
    cell = tiny("kitti-online-25mm")
    pool = inputs.make_pool(cell.config, cell.traffic, SEED, "cpu")
    assert pool.drops is None and pool.tex_idx is None
    # The frames are those of a pool mix's at the same sizes and seed.
    same = tiny("kitti-10mm")
    other = inputs.make_pool(same.config, same.traffic, SEED, "cpu")
    assert torch.equal(pool.bg, other.bg)
    assert torch.equal(pool.speeds_mps, other.speeds_mps)


def test_unknown_drop_source_is_refused():
    with pytest.raises(ValueError):
        inputs.drop_source({"drops": "xml"})


def test_online_span_shares_the_render_step():
    from raintpu_torch.utils import profiling

    harness.run(tiny("kitti-online-25mm"), SEED, 0.3, False, "cpu",
                time.perf_counter())
    drops = profiling.stage_ms("online.drops", 3)
    fog = profiling.stage_ms("render.fog", 3)
    assert len(drops) == len(fog) == 3
    assert all(np.asarray(drops) > 0) and all(np.asarray(fog) > 0)
