"""Device profiling helpers (the port's ``raintpu.utils.profiling``)
and the render path's stage spans.

A context manager around ``torch.profiler`` that writes a Chrome trace
(the timeline the JAX helper hands to TensorBoard), and a plain summary
of that timeline: the device operations that take the most time, the
longest idle gaps between them, each with the host operations that ran
meanwhile, and the device operations of each stage span.

:class:`span` times a stage of the host's work into an in-memory ring,
:data:`RING`, stamped with the render step under way
(:func:`next_step`); :func:`stage_ms` reads it back by render step.
While a profiler runs, a span is also a host range of the profile,
named as the stage, around the operations and launches the stage
issues.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from raintpu_torch import resolve_device

TRACE_FILE = "trace.json.gz"
# Host events that wait for the device: the runtime's synchronizations
# and the scalar read behind ``.item()`` (a copy to the host is counted
# by its device event, "Memcpy DtoH ...").
SYNC_EVENTS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
               "cudaEventSynchronize", "aten::_local_scalar_dense")
# The profiler's own bookkeeping, left out of the timeline.
PROFILER_EVENTS = ("Activity Buffer Request",)
# trace_summary lists the TOP_OPS device operations by total time and
# the TOP_GAPS longest idle gaps, each with the HOST_PER_GAP host
# operations that overlapped it most.
TOP_OPS = 10
TOP_GAPS = 5
HOST_PER_GAP = 3
# Device operations that no stage span encloses, in trace_summary's
# ``stages``.
OUTSIDE = "outside"
# Calls into the CUDA APIs (cuda*, cu*). Outside every host operation
# such a call is keyed by the runtime's correlation id, which can equal a
# host operation's, and then carries that operation's device records too.
# (So can the tracer's own events inside an operation, "Command Buffer
# Full" or "Buffer Flush"; they start after it, and trace_summary's
# stages count an id's records once, at its first host event.)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
# The ring's length in spans: a 51 s window of ~1,400 KITTI render
# steps at 8 spans a step, with room.
RING_SPANS = 1 << 14
# (name, parent, step, start_ns, end_ns) of the latest RING_SPANS spans,
# oldest first; parent is the name of the enclosing span on the same
# thread, or None.
RING = collections.deque(maxlen=RING_SPANS)
# Every name a span has taken in this process: trace_summary's stages.
SPAN_NAMES = set()
_local = threading.local()
# The render step under way: the number of steps begun in this process.
_step = 0


def next_step() -> int:
    """Begin a render step: the spans opened from now on carry its
    number, which is returned."""
    global _step
    _step += 1
    return _step


class span:
    """Time the block as stage ``name`` of the render step under way.

    On exit appends (name, parent, step, start_ns, end_ns) to
    :data:`RING` (``time.perf_counter_ns``). While a profiler runs, the
    block is also a host range named ``name`` in the profile
    (``torch._C._profiler._RecordFunctionFast``: not a user annotation,
    so it adds no device event). The span does not synchronize: its time
    is the host's time issuing the stage.
    """

    __slots__ = ("name", "step", "parent", "t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.step = _step

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        SPAN_NAMES.add(self.name)
        self._range = None
        if autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _local.stack.pop()
        RING.append((self.name, self.parent, self.step, self.t0, t1))
        return False


def stage_ms(name: str, steps: int) -> list:
    """Host ms spent inside span ``name`` in each of the last ``steps``
    render steps that :data:`RING` holds whole, oldest first (0.0 in a
    step where it did not open). A step is a distinct step stamp; when
    the ring is full its oldest step may have lost spans and is left
    out."""
    spans = list(RING)
    order = list(dict.fromkeys(r[2] for r in spans))
    if len(spans) == RING.maxlen:
        order = order[1:]
    ms = dict.fromkeys(order[max(len(order) - steps, 0):], 0.0)
    for n, _, step, t0, t1 in spans:
        if n == name and step in ms:
            ms[step] += (t1 - t0) / 1e6
    return list(ms.values())


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Profile everything inside the block and yield the profile.

    On a CUDA ``device`` (None: the card) the profile records CPU and
    CUDA activity, on the CPU only CPU activity. On exit it writes a
    gzipped Chrome trace, ``logdir/trace.json.gz`` (view it in
    chrome://tracing or Perfetto); :func:`trace_summary` reads the
    yielded profile after the block.
    """
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _merged(intervals):
    """Sorted (start, end) intervals with overlaps merged."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _stage_of(e, names) -> str:
    """The innermost span in ``names`` that encloses host event ``e``
    (``e`` itself included), else OUTSIDE."""
    while e is not None and e.name not in names:
        e = e.cpu_parent
    return OUTSIDE if e is None else e.name


def _stages(events, host_all, device, kind, total_us) -> dict:
    """trace_summary's ``stages``: device operations, device busy ms and
    host ms a step of each span in SPAN_NAMES, and OUTSIDE. A CUDA operation
    belongs to the host call that launched it (the profiler's
    correlation, ``FunctionEvent.kernels``) and so to that call's
    innermost span; a CPU profile's operations are host events."""
    names = SPAN_NAMES
    spans = [e for e in host_all if e.name in names]
    if not spans:
        return {}
    steps = max(collections.Counter(e.name for e in spans).values())
    rows = {n: [0, 0.0, 0.0] for n in sorted({e.name for e in spans})}
    rows[OUTSIDE] = [0, 0.0, 0.0]
    for e in spans:
        rows[e.name][2] += e.time_range.elapsed_us()
    if kind == "cuda":
        # A host call's device records include the profiler's own and
        # user annotations' ranges, which are no device operations.
        skip = set(PROFILER_EVENTS) | {
            e.name for e in events if e.device_type == DeviceType.CUDA
            and getattr(e, "is_user_annotation", False)}
        seen = set()
        for h in host_all:
            if not h.kernels or RUNTIME_CALL.match(h.name) or h.id in seen:
                continue
            seen.add(h.id)
            r = rows[_stage_of(h, names)]
            for k in h.kernels:
                if k.name not in skip:
                    r[0] += 1
                    r[1] += k.duration
        # OUTSIDE also takes the device operations linked to no host call.
        out = rows[OUTSIDE]
        out[0] += len(device) - sum(r[0] for r in rows.values())
        out[1] += total_us - sum(r[1] for r in rows.values())
    else:
        for e in device:
            r = rows[_stage_of(e, names)]
            r[0] += 1
            r[1] += e.time_range.elapsed_us()
    return {n: dict(ops=ops / steps, busy_ms=us / steps / 1e3,
                    host_ms=host_us / steps / 1e3)
            for n, (ops, us, host_us) in rows.items()}


def trace_summary(prof) -> dict:
    """The profile's timeline in three lists, and the device's busy
    share.

    Device operations are the CUDA kernels, copies and fills when the
    profile recorded any (``device`` "cuda"), else the top-level host
    operations (``device`` "cpu": a CPU profile, or one with no device
    time). The profiler's own events (PROFILER_EVENTS) and user
    annotations' device ranges are left out.
    Returns ``window_ms`` (first event's start to last event's end),
    ``busy_ms`` (the union of the device operations' intervals),
    ``busy_share``, ``n_ops`` (device operations), ``n_gaps`` (idle
    stretches between device operations), ``syncs`` (host waits for the
    device by name: SYNC_EVENTS and copies to the host), ``ops`` (the
    TOP_OPS device operations by total ms: name, ms, count), ``gaps``
    (the TOP_GAPS longest idle stretches between two device operations:
    start_ms from the window's start, ms, and the HOST_PER_GAP
    top-level host operations that overlapped it most, as (name, ms of
    overlap), with ``host_ops``, how many overlapped it) and ``stages``
    (each stage span's ``ops`` (device operations), ``busy_ms`` (their
    summed time: one stream runs them one at a time) and ``host_ms``
    (the span's own) a step, the steps being the most times one span
    opened; OUTSIDE holds the operations no span encloses, so the rows'
    ops sum to n_ops / steps; empty when no span ran).
    """
    events = [e for e in prof.events() if e.name not in PROFILER_EVENTS]
    host_all = [e for e in events if e.device_type == DeviceType.CPU]
    host = [e for e in host_all if e.cpu_parent is None]
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    kind = "cuda" if device else "cpu"
    if not device:
        device = host
    syncs = collections.Counter(
        e.name for e in events
        if e.name in SYNC_EVENTS or e.name.startswith("Memcpy DtoH"))
    if not events:
        return dict(device=kind, window_ms=0.0, busy_ms=0.0, busy_share=0.0,
                    n_ops=0, n_gaps=0, syncs={}, ops=[], gaps=[], stages={})
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)

    total = collections.defaultdict(float)
    count = collections.Counter()
    for e in device:
        total[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    ranked_ops = sorted(total.items(), key=lambda kv: -kv[1])
    ops = [dict(name=n, ms=us / 1e3, count=count[n])
           for n, us in ranked_ops[:TOP_OPS]]

    busy = _merged((e.time_range.start, e.time_range.end) for e in device)
    busy_us = sum(end - start for start, end in busy)
    idle = sorted(((a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])
    gap_recs = []
    for start, end in idle[:TOP_GAPS]:
        overlap = collections.defaultdict(float)
        for e in host:
            o = min(end, e.time_range.end) - max(start, e.time_range.start)
            if o > 0:
                overlap[e.name] += o
        ranked = sorted(overlap.items(), key=lambda kv: -kv[1])
        gap_recs.append(dict(
            start_ms=(start - t0) / 1e3, ms=(end - start) / 1e3,
            host_ops=sum(1 for e in host
                         if e.time_range.start < end
                         and e.time_range.end > start),
            host=[(n, us / 1e3) for n, us in ranked[:HOST_PER_GAP]]))
    window_us = max(t1 - t0, 1e-9)
    return dict(device=kind, window_ms=window_us / 1e3,
                busy_ms=busy_us / 1e3, busy_share=busy_us / window_us,
                n_ops=len(device), n_gaps=len(idle), syncs=dict(syncs),
                ops=ops, gaps=gap_recs,
                stages=_stages(events, host_all, device, kind,
                               sum(total.values())))
