"""The online job's keyed simulation and count replay as CUDA graphs
(``physics/simulator.SIM_GRAPHS``, ``TRUNCATION_GRAPHS``), on the CPU.

The rule that engages the graphs (:func:`graph_device`), a CPU call that
makes no graph, and the caches' course over several sets of frames with
the stand-in for ``torch.cuda.CUDAGraph`` of ``torch_graph_stand_in``,
whose graphs draw from generators of their own: replays equal to the
eager loop bit for bit, the callers' generators left where the eager
loop leaves them, a kept result that a later call does not overwrite,
the keys, the profiler rule and the spans. The card's own graphs are
held to the eager loop in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import types

import pytest
import torch

from raintpu_torch.physics import simulator
from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                             simulate_frames_keyed,
                                             truncated_counts)
from raintpu_torch.utils import graphs, profiling
import torch_graph_stand_in
from torch_cpu_threads import one_torch_thread  # noqa: F401

B = 3
SEED = 2524000101
# A small camera whose capacity the heavier frames' counts pass, so that
# the count replay has drops to count.
CFG = SimConfig(image_wh=(160, 96), focal_px=(200.0, 200.0),
                exposure_s=2e-3, capacity=10, z_max=8.0)
SPANS = {"drops": "sim.replay", "counts": "sim.truncation.replay"}


def _columns(frames):
    """The schedule's four columns of ``frames``: fall rate, camera speed,
    exposure and focal scale, each frame its own."""
    f = torch.as_tensor(frames, dtype=torch.float32)
    return (60.0 + 40.0 * (f % 3), 27.8 - f, 2e-3 + 1e-4 * (f % 2),
            1.0 + 0.01 * (f % 4))


def _generators(frames):
    return [frame_generator(SEED, f, "cpu") for f in frames]


def _call(what, frames, cfg=CFG):
    """(result, the callers' generators after the call)."""
    gens = _generators(frames)
    cols = _columns(frames)
    if what == "drops":
        return simulate_frames_keyed(gens, cfg, *cols), gens
    return truncated_counts(gens, cfg, cols[0]), gens


def _eager(what, frames, cfg=CFG):
    with pytest.MonkeyPatch.context() as eager:
        eager.setattr(simulator, "graph_device", lambda *a: None)
        return _call(what, frames, cfg)


def _assert_equal(got, want):
    got = torch_graph_stand_in.leaves(got)
    want = torch_graph_stand_in.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _assert_same_states(got, want):
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.get_state(), w.get_state())


def _replays(span):
    return sum(r[0] == span for r in profiling.RING)


def _frame_sets(n):
    return [list(range(i * B, (i + 1) * B)) for i in range(n)]


@pytest.fixture
def stand_in(monkeypatch):
    """Fresh caches that engage on the CPU, over stand-in graphs."""
    caches = {"drops": graphs.GraphCache("sim.replay"),
              "counts": graphs.GraphCache("sim.truncation.replay")}
    monkeypatch.setattr(simulator, "SIM_GRAPHS", caches["drops"])
    monkeypatch.setattr(simulator, "TRUNCATION_GRAPHS", caches["counts"])
    monkeypatch.setattr(simulator, "graph_device",
                        lambda gens, tensors: torch.device("cpu"))
    torch_graph_stand_in.install(monkeypatch)
    return caches


def _dev(d):
    return types.SimpleNamespace(device=torch.device(d))


CUDA0 = _dev("cuda:0")
CASES = {
    "one card": ([_dev("cuda:0") for _ in range(3)], [CUDA0], "cuda:0"),
    # A CUDA generator made without an index is on the current card.
    "the current card": ([_dev("cuda") for _ in range(3)], [CUDA0],
                         "cuda:0"),
    "not the current card": ([_dev("cuda")], [_dev("cuda:1")], None),
    "cpu": ([_dev("cpu") for _ in range(3)], [_dev("cpu")], None),
    "a tensor on the cpu": ([_dev("cuda:0")], [CUDA0, _dev("cpu")], None),
    "two cards": ([_dev("cuda:0"), _dev("cuda:1")], [CUDA0], None),
    "a generator twice": ([CUDA0, CUDA0], [CUDA0], None),
    "no generator": ([], [CUDA0], None),
    "the default generator": ([_dev("cuda:0"), None], [CUDA0], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_device_rule(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    gens, tensors, want = CASES[case]
    got = simulator.graph_device(gens, tensors)
    assert got == (None if want is None else torch.device(want))


@pytest.mark.parametrize("what", sorted(SPANS))
def test_cpu_call_makes_no_graph(what, monkeypatch):
    caches = {"drops": graphs.GraphCache("sim.replay"),
              "counts": graphs.GraphCache("sim.truncation.replay")}
    monkeypatch.setattr(simulator, "SIM_GRAPHS", caches["drops"])
    monkeypatch.setattr(simulator, "TRUNCATION_GRAPHS", caches["counts"])
    before = _replays(SPANS[what])
    for frames in _frame_sets(3):
        got, gens = _call(what, frames)
        # The loop as it reads, frame by frame on its own generator.
        want_gens = _generators(frames)
        cols = _columns(frames)
        if what == "drops":
            want = simulator.stack_batches([
                simulator.simulate_frames(g, CFG,
                                          *(c[b:b + 1] for c in cols))
                for b, g in enumerate(want_gens)])
        else:
            want = torch.cat([
                simulator.truncated_count(g, CFG, cols[0][b:b + 1])
                for b, g in enumerate(want_gens)])
        _assert_equal(got, want)
        _assert_same_states(gens, want_gens)
    assert _replays(SPANS[what]) == before
    for cache in caches.values():
        assert cache.captures == 0 and not cache._entries


@pytest.mark.parametrize("what", sorted(SPANS))
def test_replays_equal_the_eager_loop(what, stand_in):
    """Four sets of frames under one key: the first call runs eagerly,
    the second captures, the rest replay; each result bit for bit the
    eager loop's, each caller's generator in the eager loop's end state,
    and the replay span open in every call but the first."""
    sets = _frame_sets(4)
    want = [_eager(what, f) for f in sets]
    if what == "counts":
        # Frames the clamp cuts and frames it leaves whole.
        every = torch.cat([w for w, _ in want])
        assert bool((every > 0).any()) and bool((every == 0).any())
    else:
        assert all(int(w.valid.sum()) > 0 for w, _ in want)
    span = SPANS[what]
    for i, frames in enumerate(sets):
        before = _replays(span)
        got, gens = _call(what, frames)
        assert _replays(span) - before == (i > 0)
        _assert_equal(got, want[i][0])
        _assert_same_states(gens, want[i][1])
    cache = stand_in[what]
    assert cache.captures == 1
    other = stand_in["counts" if what == "drops" else "drops"]
    assert other.captures == 0 and not other._entries
    (entry,) = cache._entries.values()
    # The graph drew from generators of its own, one a frame, registered
    # before its capture began.
    assert len(entry.generators) == B
    assert entry.graph.registered_at_capture == entry.generators


@pytest.mark.parametrize("what", sorted(SPANS))
def test_kept_results_are_not_overwritten(what, stand_in):
    """The caller owns what a replay returns: results kept over five
    calls under one key stay the eager loop's."""
    sets = _frame_sets(5)
    kept = [_call(what, f)[0] for f in sets]
    assert stand_in[what].captures == 1
    for got, frames in zip(kept, sets):
        _assert_equal(got, _eager(what, frames)[0])


def test_a_drawn_generator_goes_on_as_the_eager_loop(stand_in):
    """Generators that drew before the call, and that the simulation's
    count replay then draws from again: the states carried into the
    graph and back are the whole state, not a fresh seed."""
    frames = _frame_sets(1)[0]
    cols = _columns(frames)

    def run():
        gens = _generators(frames)
        for g in gens:
            torch.rand(5, generator=g)
        out = []
        for _ in range(3):
            out.append(simulate_frames_keyed(gens, CFG, *cols))
            out.append(truncated_counts(gens, CFG, cols[0]))
        return out, gens

    got, gens = run()
    with pytest.MonkeyPatch.context() as eager:
        eager.setattr(simulator, "graph_device", lambda *a: None)
        want, want_gens = run()
    for g, w in zip(got, want):
        _assert_equal(g, w)
    _assert_same_states(gens, want_gens)
    assert stand_in["drops"].captures == stand_in["counts"].captures == 1


@pytest.mark.parametrize("what", sorted(SPANS))
def test_no_capture_under_a_profiler(what, stand_in):
    sets = _frame_sets(4)
    span = SPANS[what]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for frames in sets[:3]:
            before = _replays(span)
            _assert_equal(_call(what, frames)[0], _eager(what, frames)[0])
            assert _replays(span) == before
    assert stand_in[what].captures == 0
    _call(what, sets[0])
    assert stand_in[what].captures == 1
    # A replay under a profiler is fine.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        before = _replays(span)
        _assert_equal(_call(what, sets[3])[0], _eager(what, sets[3])[0])
        assert _replays(span) == before + 1
    assert stand_in[what].captures == 1


@pytest.mark.parametrize("what", sorted(SPANS))
def test_keys_recapture_and_evict(what, stand_in):
    """Another SimConfig or another number of frames is a key of its
    own: seen once, then captured; a cache keeps four keys."""
    cache = stand_in[what]
    frames = _frame_sets(1)[0]
    for _ in range(3):
        _call(what, frames)
    assert cache.captures == 1
    variants = [(dataclasses.replace(CFG, capacity=8), frames),
                (dataclasses.replace(CFG, render_scale=2.0), frames),
                (CFG, frames[:2])]
    for cfg, fr in variants:
        want = _eager(what, fr, cfg)
        before = cache.captures
        _assert_equal(_call(what, fr, cfg)[0], want[0])
        assert cache.captures == before
        for _ in range(2):
            got, gens = _call(what, fr, cfg)
            _assert_equal(got, want[0])
            _assert_same_states(gens, want[1])
        assert cache.captures == before + 1
    assert len(cache._entries) == graphs.KEYS
    # A fifth key evicts the oldest used: the first configuration's.
    _call(what, frames, dataclasses.replace(CFG, z_bins=128))
    assert len(cache._entries) == graphs.KEYS
    before = cache.captures
    _call(what, frames)
    _call(what, frames)
    assert cache.captures == before + 1
