"""The port's benchmark suite and profiling helpers
(``raintpu_torch.tools.bench_suite``, ``raintpu_torch.utils.profiling``)
against raintpu's, on the CPU at tiny sizes.

Randomness crosses as data: the port's ``_common`` is given raintpu's
simulated drops (its ``simulate_frames`` replaced by one that returns
them), so both sides size, compact and fit the same population, and a
step renders the same texture picks on both sides. Sizing, compaction
and the fitted ladder are equal; one step's scalar agrees within rtol
1e-4, its rendered rain mask and image within 2e-4 a pixel (raintpu
renders through its XLA path on the CPU, the port through its fused
path's plain version: the fused path's own bar against the XLA path,
with test_torch_golden's rule for ALPHA_CUTOFF flips) and the saved
envmap within 1e-5.
"""

import functools
import io
import json
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.ops import rasterize as jrz
from raintpu.physics import simulator as jsim
from raintpu.render import frame as jframe
from raintpu.tools import bench_suite as jbs
from raintpu_torch import interop
from raintpu_torch.particles.schema import DropBatch
from raintpu_torch.render import frame as tframe
from raintpu_torch.tools import bench_suite as bs
from raintpu_torch.utils import profiling
from test_torch_golden import RENDER_ATOL, assert_render_close
from torch_cpu_threads import one_torch_thread  # noqa: F401

B, W, H = 2, 160, 64
SCALAR_RTOL = 1e-4
ENVMAP_ATOL = 1e-5


def _raintpu_common(monkeypatch, fallrate, capacity=None, drops=None,
                    **cfg_kw):
    """raintpu's ``_common`` and the drops its simulation made (or, with
    ``drops``, given those drops in place of its simulation)."""
    made = {}
    real = jsim.simulate_frames

    def record(key, sim_cfg, *rest):
        made["sim_cfg"] = sim_cfg
        made["drops"] = real(key, sim_cfg, *rest) if drops is None else drops
        return made["drops"]

    monkeypatch.setattr(jsim, "simulate_frames", record)
    try:
        return jbs._common(B, W, H, fallrate, capacity, **cfg_kw), made
    finally:
        monkeypatch.setattr(jsim, "simulate_frames", real)


def _port_common(monkeypatch, jdrops, fallrate, capacity=None, **cfg_kw):
    """The port's ``_common`` given raintpu's simulated drops, and the
    simulation capacity it asked for."""
    asked = {}

    def given(gen, sim_cfg, *rest):
        asked["sim_cfg"] = sim_cfg
        return interop.drop_batch_from_numpy(interop.numpy_fields(jdrops),
                                             device="cpu")

    monkeypatch.setattr(bs, "simulate_frames", given)
    return bs._common(B, W, H, fallrate, capacity, device="cpu",
                      **cfg_kw), asked


def _numpy_drops(drops) -> dict:
    return {k: np.asarray(v) for k, v in interop.numpy_fields(drops).items()}


@pytest.fixture(scope="module")
def scenes():
    """(raintpu's _common output, the port's Scene) on the same drops,
    for the sweep at 25 mm/hr and Cityscapes (envmap) at 5 mm/hr."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, fallrate, kw in (("kitti", 25, {}),
                                   ("cityscapes", 5, {"save_envmap": True})):
            want, made = _raintpu_common(mp, fallrate, **kw)
            got, asked = _port_common(mp, made["drops"], fallrate, **kw)
            out[name] = (want, got, made, asked)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["kitti", "cityscapes"])
def test_common_sizes_the_scene_as_raintpu(scenes, name):
    (jcfg, jsim_cfg, jdrops, jbg, jdepth, _, jbank, jedges), got, made, \
        asked = scenes[name]
    # The same simulation capacity, asked of the simulator and returned.
    assert asked["sim_cfg"].capacity == made["sim_cfg"].capacity
    assert got.sim_cfg.capacity == jsim_cfg.capacity
    assert got.sim_cfg.image_wh == tuple(jsim_cfg.image_wh)
    cap = made["sim_cfg"].capacity
    expect = jsim.expected_drop_count(
        jsim.SimConfig.from_settings(jcfg.settings, capacity=1),
        float(jcfg.fallrate))
    assert cap == -(-(expect + 5 * np.sqrt(expect) + 64) // 256) * 256
    # The render capacity from the largest count, 128-aligned.
    most = int(np.asarray(made["drops"].count()).max())
    assert got.drops.capacity == jdrops.valid.shape[-1] \
        == -(-most // 128) * 128
    # Compaction: the same counts and the same fields.
    want = _numpy_drops(jdrops)
    for k, v in _numpy_drops(got.drops).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(got.drops.count().numpy(),
                                  np.asarray(jdrops.count()))
    # The fitted ladder, cds 4 and the options.
    assert [tuple(b.__dict__.values()) for b in got.cfg.raster.buckets] == \
        [tuple(b.__dict__.values()) for b in jcfg.raster.buckets]
    assert got.cfg.cone_downsample == jcfg.cone_downsample == 4
    assert got.cfg.save_envmap == jcfg.save_envmap
    assert got.cfg.image_hw == tuple(jcfg.image_hw) == (H, W)
    np.testing.assert_array_equal(got.bg.numpy(), np.asarray(jbg))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(jdepth))
    np.testing.assert_array_equal(got.bank.raw.numpy(), np.asarray(jbank.raw))
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(jedges))


def test_common_with_a_capacity_and_its_assertions(scenes, monkeypatch):
    """With a capacity the simulation holds twice it; both sides fail the
    same way on the same drops when that saturates or truncates."""
    drops = scenes["kitti"][2]["drops"]
    most = int(np.asarray(drops.count()).max())
    assert most >= 3, "the scene must hold a few drops"
    _, made = _raintpu_common(monkeypatch, 25, capacity=most, drops=drops)
    got, asked = _port_common(monkeypatch, drops, 25, capacity=most)
    assert asked["sim_cfg"].capacity == made["sim_cfg"].capacity == 2 * most
    assert got.drops.capacity == most
    for capacity, words in ((most - 1, "render capacity truncates"),
                            (most // 2, "simulation capacity saturated")):
        with pytest.raises(AssertionError) as want:
            _raintpu_common(monkeypatch, 25, capacity=capacity, drops=drops)
        with pytest.raises(AssertionError) as got:
            _port_common(monkeypatch, drops, 25, capacity=capacity)
        assert str(got.value) == str(want.value)
        assert str(got.value).startswith(words)


@pytest.mark.parametrize("name", ["kitti", "cityscapes"])
def test_step_matches_raintpus_step(scenes, name):
    """One step (i = 1) of the sweep and of Cityscapes: raintpu's keys
    folded by the step, and their texture picks passed to the port."""
    (jcfg, _, jdrops, jbg, jdepth, keys, jbank, jedges), got, _, _ = \
        scenes[name]
    envmap = name == "cityscapes"
    i = 1
    k = jax.vmap(lambda kk: jax.random.fold_in(kk, i))(keys)
    out = jax.jit(lambda *a: jframe.render_frames(*a, jcfg))(
        jbg, jdepth, jdrops, jbank, jedges, k)
    want = (jnp.sum(out.rain_mask[:, ::97, ::97])
            + jnp.sum(out.rainy_image[:, ::97, ::97]))
    if envmap:
        want = want + jnp.sum(out.envmap)
    tex_idx = torch.as_tensor(np.array(jax.vmap(
        lambda d, kk: jrz.select_textures(
            d, jedges, jax.random.split(kk)[0]))(jdrops, k)))

    step = bs.render_step(got.cfg, envmap=envmap)
    value = step(i, bs.DRAW_SEED, got.bg, got.depth, got.drops, got.bank,
                 got.edges, tex_idx=tex_idx)
    assert value.shape == ()
    np.testing.assert_allclose(value.item(), float(want), rtol=SCALAR_RTOL)
    port = tframe.render_frames(got.bg, got.depth, got.drops, got.bank,
                                got.edges, got.cfg, tex_idx=tex_idx)
    assert float(port.rain_mask.sum()) > 1e-2
    assert port.rainy_image.shape == out.rainy_image.shape == (B, H, W, 3)
    assert_render_close(port, out, ("rain_mask", "rainy_image"),
                        atol=RENDER_ATOL)
    if envmap:
        assert port.envmap.shape == out.envmap.shape
        np.testing.assert_allclose(port.envmap.numpy(),
                                   np.asarray(out.envmap), atol=ENVMAP_ATOL)
    else:
        assert port.envmap is None and out.envmap is None


@pytest.mark.parametrize("mask,overflow,words", [
    (0.0, 0, "no rain rendered"),
    (1.0, 1, "1.0 drops overflowed bucket capacity")])
def test_assert_rain_raises(mask, overflow, words):
    out = types.SimpleNamespace(
        rain_mask=torch.full((1, 4, 4), mask),
        overflow=torch.tensor([[0, overflow]], dtype=torch.int32))
    with pytest.raises(AssertionError, match=words):
        bs.assert_rain(out)
    ok = types.SimpleNamespace(rain_mask=torch.full((1, 4, 4), 1.0),
                               overflow=torch.zeros((1, 2), dtype=torch.int32))
    assert bs.assert_rain(ok) == 16.0
    # The bar is the caller's: the mass must lie above it.
    with pytest.raises(AssertionError, match="no rain rendered"):
        bs.assert_rain(ok, min_mass=16.0)


def _fake_drops():
    n = 3
    f = torch.zeros
    return DropBatch(ip1=f(n, 2), ip2=f(n, 2), iw1=f(n), iw2=f(n),
                     wp1=f(n, 3), wp2=f(n, 3),
                     max_width=torch.arange(n, dtype=torch.int32),
                     length=torch.ones(n, dtype=torch.int32), ratio=f(n),
                     drop_type=torch.zeros(n, dtype=torch.int32),
                     valid=torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("iters,perturb_ix", [(6, (1, 2, 3)), (3, (1, 2))])
def test_timed_perturbs_floats_by_step(iters, perturb_ix):
    base = torch.zeros(4)
    ints = torch.arange(4, dtype=torch.int32)
    drops = _fake_drops()
    static = torch.zeros(2)
    data = (7, base, drops, ints, static)
    calls = []

    def step(i, seed, x, dr, n, s):
        calls.append((i, seed, x, dr, n, s))
        return x.sum() + 1.0

    sec = bs.timed(step, data, iters=iters, perturb_ix=perturb_ix)
    assert sec > 0
    assert len(calls) == iters + 1
    assert [c[0] for c in calls] == [0] + list(range(iters))
    for i, seed, x, dr, n, s in calls:
        eps = torch.tensor(i * 1e-12, dtype=torch.float32)
        assert seed == 7 and s is static
        assert torch.equal(x, base + eps)
        assert n is ints or torch.equal(n, ints)
        for name in ("iw1", "wp1", "ratio", "ip2"):
            want = getattr(drops, name) + (eps if 2 in perturb_ix else 0)
            assert torch.equal(getattr(dr, name), want), name
        for name in ("max_width", "length", "drop_type", "valid"):
            assert torch.equal(getattr(dr, name), getattr(drops, name))
            assert getattr(dr, name).dtype == getattr(drops, name).dtype


def test_timed_rejects_nan():
    with pytest.raises(AssertionError, match="NaN"):
        bs.timed(lambda i, x: x.sum() * float("nan"), (torch.ones(2),),
                  iters=2, perturb_ix=(0,))


TINY = {
    "kitti_sweep": dict(fallrates=(5, 25)),
    "cityscapes_envmap": {},
    "nuscenes_6cam": {},
    "online": {},
    "sharded": dict(capacity=64),
}


def _tiny_configs(monkeypatch, failing=None):
    configs = {name: functools.partial(bs.CONFIGS[name], B=B, W=W, H=H,
                                       iters=2, **kw)
               for name, kw in TINY.items()}
    if failing:
        def boom(device=None):
            raise RuntimeError("deliberate failure")
        configs[failing] = boom
    monkeypatch.setattr(bs, "CONFIGS", configs)
    return configs


def _run_main(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bs.main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_main_prints_one_line_per_config(monkeypatch):
    _tiny_configs(monkeypatch)
    rc, lines = _run_main(["--device", "cpu"])
    assert rc == 0
    assert len(lines) == len(TINY)
    for rec in lines:
        assert set(rec) == {"metric", "value", "unit", "device"}, rec
        assert rec["unit"] == "images/s" and rec["value"] > 0
        assert rec["device"] == "cpu"
    assert lines[0]["metric"] == "KITTI sweep {5,25}mm/hr"
    assert "truncated=0, overflow=0" in lines[2]["metric"]
    assert lines[4]["metric"].startswith("sharded dp=1 x sp=1")
    assert not torch.distributed.is_initialized()


def test_main_reports_a_failing_config_and_exits_1(monkeypatch):
    _tiny_configs(monkeypatch, failing="online")
    rc, lines = _run_main(["cityscapes_envmap", "online", "--device", "cpu"])
    assert rc == 1
    assert len(lines) == 2
    assert lines[0]["unit"] == "images/s"
    assert lines[1] == {"metric": "online",
                        "error": "RuntimeError: deliberate failure"}


def test_main_refuses_without_a_card_or_a_known_config():
    with pytest.raises(SystemExit):
        bs.main(["nonesuch", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(SystemExit, match="no CUDA card"):
        bs.main(["kitti_sweep"])


def test_device_trace_and_summary_on_the_cpu(tmp_path):
    x = torch.rand(64, 64)
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            (x @ x).relu().sum()
    assert (tmp_path / profiling.TRACE_FILE).stat().st_size > 0
    s = profiling.trace_summary(prof)
    names = [op["name"] for op in s["ops"]]
    assert "aten::matmul" in names and len(names) <= profiling.TOP_OPS
    assert all(op["ms"] > 0 and op["count"] >= 1 for op in s["ops"])
    assert 0.0 < s["busy_share"] <= 1.0
    assert 0.0 < s["busy_ms"] <= s["window_ms"]
    assert len(s["gaps"]) <= profiling.TOP_GAPS
    assert s["n_gaps"] >= len(s["gaps"])
    assert all(len(g["host"]) <= profiling.HOST_PER_GAP for g in s["gaps"])
    assert all(g["ms"] > 0 for g in s["gaps"])
    assert s["device"] == "cpu" and s["n_ops"] >= 9
    assert s["syncs"] == {}


def test_timed_scalar_returns_ms():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2).sum()

    ms = profiling.timed_scalar(fn, torch.ones(8), iters=3, warmup=2)
    assert ms > 0 and len(calls) == 5
