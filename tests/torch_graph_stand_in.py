"""A stand-in for ``torch.cuda.CUDAGraph`` under ``utils/graphs.GraphCache``,
for the CPU tests of the port's graph caches.

A capture runs the function on the graph's input buffers (and, where it
draws, on the graph's own generators); a replay runs it again there, with
no spans, and copies the result into the outputs the capture returned.
Its generators are real ones: a replay draws from the state they were
given before it and leaves them advanced by what it drew, as a CUDA
graph's registered generators are. The graph records the generators
registered with it before its capture began.
"""

import contextlib
import dataclasses

import pytest
import torch

from raintpu_torch.utils import graphs, profiling


class StandInGraph:
    """torch.cuda.CUDAGraph's stand-in: its replay is set at capture."""

    replay = None

    def __init__(self):
        self.registered = []
        self.registered_at_capture = None

    def register_generator_state(self, generator):
        self.registered.append(generator)


def leaves(x):
    """The tensors of ``x``: a tensor, a dataclass or a sequence of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in leaves(getattr(x, f.name))]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    return []


def install(monkeypatch):
    """Every GraphCache captures stand-in graphs until the test ends."""

    @contextlib.contextmanager
    def capturing(graph, stream=None, capture_error_mode=None):
        graph.registered_at_capture = tuple(graph.registered)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", capturing)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: None)
    capture = graphs.GraphCache._capture

    def capture_and_replay(self, fn, args, device, held, generators):
        entry = capture(self, fn, args, device, held, generators)
        lead = () if generators is None else (entry.generators,)

        def replay():
            # A graph's replay runs no Python, so it opens no span.
            with pytest.MonkeyPatch.context() as quiet:
                quiet.setattr(profiling, "span",
                              lambda name: contextlib.nullcontext())
                fresh = fn(*lead, *entry.inputs)
            for out, new in zip(leaves(entry.outputs), leaves(fresh)):
                out.copy_(new)

        entry.graph.replay = replay
        return entry

    monkeypatch.setattr(graphs.GraphCache, "_capture", capture_and_replay)
