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
envmap within 1e-5. The span ring keeps its bound, its thread-local
parents and its step stamps, and enters no profiler range without a
profiler.
"""

import collections
import functools
import io
import json
import threading
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

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



@pytest.fixture
def ring(monkeypatch):
    """A fresh span ring of 6 spans."""
    fresh = collections.deque(maxlen=6)
    monkeypatch.setattr(profiling, "RING", fresh)
    return fresh


def test_span_ring_is_bounded_and_stamps_steps(ring):
    steps = []
    for _ in range(4):
        steps.append(profiling.next_step())
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert steps == list(range(steps[0], steps[0] + 4))
    assert len(ring) == 6
    assert [(n, p, st) for n, p, st, _, _ in ring] == [
        (n, p, st) for st in steps[1:]
        for n, p in (("inner", "outer"), ("outer", None))]
    for _, _, _, t0, t1 in ring:
        assert 0 < t0 <= t1
    # An inner span lies within its outer one.
    assert ring[4][3] >= ring[5][3] and ring[4][4] <= ring[5][4]


def test_span_parents_are_thread_local(ring):
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.span("outer-" + tag):
            both_open.wait()
            with profiling.span("inner-" + tag):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    parents = {n: p for n, p, _, _, _ in ring}
    assert parents == {"outer-a": None, "outer-b": None,
                       "inner-a": "outer-a", "inner-b": "outer-b"}


def test_span_enters_a_profiler_range_only_under_a_profiler(ring,
                                                            monkeypatch,
                                                            tmp_path):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    with profiling.span("render.quiet"):
        torch.ones(4).sum()
    assert entered == [] and ring[-1][0] == "render.quiet"
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.span("render.traced"):
            torch.ones(4).sum()
    assert entered == ["render.traced"]


def test_stage_ms_reads_the_last_steps(ring):
    def add(name, step, ms):
        ring.append((name, None, step, 0, int(ms * 1e6)))

    add("a", 1, 1.0)
    add("b", 1, 5.0)
    add("a", 2, 2.0)
    add("a", 2, 0.5)
    add("b", 3, 7.0)
    # Steps 1-3 whole; a per step, the last two steps, then all three.
    assert profiling.stage_ms("a", 2) == [2.5, 0.0]
    assert profiling.stage_ms("a", 5) == [1.0, 2.5, 0.0]
    assert profiling.stage_ms("b", 1) == [7.0]
    assert profiling.stage_ms("a", 0) == []
    # A full ring may have lost part of its oldest step: it is left out.
    add("a", 4, 3.0)
    assert len(ring) == ring.maxlen
    assert profiling.stage_ms("a", 9) == [2.5, 0.0, 3.0]


class _Event(types.SimpleNamespace):
    """A profiler event as trace_summary reads one."""

    def __init__(self, name, start, end, device="cpu", parent=None, id=0,
                 kernels=()):
        super().__init__(
            name=name, id=id, cpu_parent=parent, kernels=list(kernels),
            is_user_annotation=False,
            device_type=(DeviceType.CUDA if device == "cuda"
                         else DeviceType.CPU),
            time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))


def test_trace_summary_attributes_device_operations_to_stages(monkeypatch):
    """A CUDA operation belongs to the host call it is linked to, and so
    to that call's innermost span; a runtime call whose id collides with
    a host operation's does not count its records again; operations no
    span encloses are OUTSIDE; the rows sum to the operations a step."""
    monkeypatch.setattr(profiling, "SPAN_NAMES", {"render.a", "render.b"})
    kern = collections.namedtuple(
        "Kernel", "name device duration")
    events, device = [], []
    for step in range(2):
        t = 1000 * step
        a = _Event("render.a", t, t + 100)
        b = _Event("render.b", t + 100, t + 300)
        mul = _Event("aten::mul", t + 10, t + 20, parent=a, id=10 + step,
                     kernels=[kern("k_mul", 0, 5.0)])
        add = _Event("aten::add", t + 110, t + 120, parent=b, id=20 + step,
                     kernels=[kern("k_add", 0, 7.0), kern("k_add", 0, 7.0)])
        # A runtime call keyed by the runtime's own correlation id, which
        # equals aten::add's.
        sync = _Event("cudaStreamSynchronize", t + 40, t + 50, parent=a,
                      id=20 + step, kernels=list(add.kernels))
        device += [_Event("k_mul", t + 30, t + 35, "cuda"),
                   _Event("k_add", t + 130, t + 137, "cuda"),
                   _Event("k_add", t + 140, t + 147, "cuda"),
                   _Event("k_fill", t + 500, t + 502, "cuda")]
        events += [a, b, mul, add, sync]
    timeline = sorted(events + device, key=lambda e: e.time_range.start)
    prof = types.SimpleNamespace(events=lambda: timeline)
    s = profiling.trace_summary(prof)
    st = s["stages"]
    assert s["device"] == "cuda" and s["n_ops"] == 8
    assert st["render.a"] == dict(ops=1.0, busy_ms=0.005, host_ms=0.1)
    assert st["render.b"] == dict(ops=2.0, busy_ms=0.014, host_ms=0.2)
    assert st[profiling.OUTSIDE] == pytest.approx(
        dict(ops=1.0, busy_ms=0.002, host_ms=0.0))
    assert sum(r["ops"] for r in st.values()) * 2 == s["n_ops"]
