"""A function of tensors replayed as a captured CUDA graph.

:class:`GraphCache` stands in for a function whose host time is mostly
the launches of many small device operations. Under a key the caller
derives from everything the function's work depends on, the first call
runs the function eagerly (it warms the allocator, the libraries'
handles and any constants the function makes once); the second captures
it as a CUDA graph (``torch.cuda.CUDAGraph``, with a memory pool of its
own) and replays it; every later call copies its tensors into the
graph's own input buffers and replays the graph: the same kernels, in
the same order, on the same values, issued by one host call.

A function may draw from generators of the caller's (``generators``):
the graph then draws from generators of its own, one for each, which it
registers before the capture. Before each replay every caller
generator's state (on CUDA its seed and Philox offset) is copied into
the graph's generator; the replay draws from that state and advances
the graph's generator by what it consumed, and the caller's generator
takes the state it ends in. So a replay draws what the eager call draws
and leaves the caller's generators where the eager call leaves them.

A replay returns the graph's own output tensors, which the next replay
under that key overwrites: a caller consumes them, on the same stream,
before it calls again, and copies what it keeps. A capture waits for the
device, and never happens while ``torch.profiler`` records (a replay
may). The cache serves one thread.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence

import torch
from torch.autograd import profiler as autograd_profiler

from raintpu_torch.utils import profiling

# The keys a cache holds, seen or captured: the oldest used goes first.
KEYS = 4
# The entry of a key seen once: the next call under it captures.
_SEEN = object()


class _Captured:
    """One captured graph: its input buffers, its outputs, the tensors
    it reads that the key names by identity and the generators it draws
    from."""

    __slots__ = ("graph", "inputs", "outputs", "held", "generators")

    def __init__(self, graph, inputs, outputs, held, generators):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.held = held
        self.generators = generators


class GraphCache:
    """The graphs of one function, by key, at most :data:`KEYS` keys. A
    replay runs inside a :class:`~raintpu_torch.utils.profiling.span`
    named ``span``; ``captures`` counts the graphs captured."""

    def __init__(self, span: str):
        self.span = span
        self.captures = 0
        self._entries = collections.OrderedDict()

    def __call__(self, key, fn: Callable,
                 args: Sequence[Optional[torch.Tensor]],
                 device: torch.device, held: Sequence[torch.Tensor] = (),
                 generators: Optional[Sequence[torch.Generator]] = None):
        """``fn(*args)``, or its graph's replay on ``args``; with
        ``generators``, ``fn(generators, *args)``.

        ``key`` names everything the work depends on besides the values
        of ``args``: the shapes and dtypes of ``args`` (None stays None),
        the function's settings, the number of ``generators``, and, by
        ``id``, each tensor ``fn`` reads that is not an argument; those
        are ``held`` while the graph lives, so no other tensor takes
        their ``id``. The input buffers and the graph's generators live
        on ``device``, a CUDA device, as ``generators`` do; no two of
        ``generators`` are one generator."""
        lead = () if generators is None else (generators,)
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _SEEN
            while len(self._entries) > KEYS:
                self._entries.popitem(last=False)
            return fn(*lead, *args)
        self._entries.move_to_end(key)
        if entry is _SEEN:
            if autograd_profiler._is_profiler_enabled:
                return fn(*lead, *args)
            entry = self._capture(fn, args, device, held, generators)
            self._entries[key] = entry
        with profiling.span(self.span):
            for buf, a in zip(entry.inputs, args):
                if buf is not None:
                    buf.copy_(a)
            for own, g in zip(entry.generators, generators or ()):
                own.set_state(g.get_state())
            entry.graph.replay()
            for own, g in zip(entry.generators, generators or ()):
                g.set_state(own.get_state())
        return entry.outputs

    def _capture(self, fn, args, device, held, generators) -> _Captured:
        """``fn`` captured on a side stream, on input buffers that hold
        copies of ``args`` and, with ``generators``, on generators of
        the graph's own, registered with it (a capture runs nothing: the
        replay that follows computes)."""
        inputs = [None if a is None
                  else a.to(device=device, copy=True,
                            memory_format=torch.contiguous_format)
                  for a in args]
        graph = torch.cuda.CUDAGraph()
        own = tuple(torch.Generator(device=device)
                    for _ in generators or ())
        for g in own:
            graph.register_generator_state(g)
        lead = () if generators is None else (own,)
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                  capture_error_mode="thread_local"):
                outputs = fn(*lead, *inputs)
        self.captures += 1
        return _Captured(graph, inputs, outputs, tuple(held), own)
