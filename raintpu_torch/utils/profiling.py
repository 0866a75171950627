"""Device profiling helpers (the port's ``raintpu.utils.profiling``).

A context manager around ``torch.profiler`` that writes a Chrome trace
(the timeline the JAX helper hands to TensorBoard), a plain summary of
that timeline — the device operations that take the most time and the
longest idle gaps between them, each with the host operations that ran
meanwhile — and a timing helper that forces completion by fetching the
scalar each call returns.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch.autograd import DeviceType
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


def trace_summary(prof) -> dict:
    """The profile's timeline in two lists, and the device's busy share.

    Device operations are the CUDA kernels and copies when the profile
    recorded any (``device`` "cuda"), else the top-level host operations
    (``device`` "cpu": a CPU profile, or one with no device time). The
    profiler's own events (PROFILER_EVENTS) are left out.
    Returns ``window_ms`` (first event's start to last event's end),
    ``busy_ms`` (the union of the device operations' intervals),
    ``busy_share``, ``n_ops`` (device operations), ``n_gaps`` (idle
    stretches between device operations), ``syncs`` (host waits for the
    device by name: SYNC_EVENTS and copies to the host), ``ops`` (the
    TOP_OPS device operations by total ms: name, ms, count) and ``gaps``
    (the TOP_GAPS longest idle stretches between two device operations:
    start_ms from the window's start, ms, and the HOST_PER_GAP
    top-level host operations that overlapped it most, as (name, ms of
    overlap), with ``host_ops``, how many overlapped it).
    """
    events = [e for e in prof.events() if e.name not in PROFILER_EVENTS]
    host = [e for e in events
            if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kind = "cuda" if device else "cpu"
    if not device:
        device = host
    syncs = collections.Counter(
        e.name for e in events
        if e.name in SYNC_EVENTS or e.name.startswith("Memcpy DtoH"))
    if not events:
        return dict(device=kind, window_ms=0.0, busy_ms=0.0, busy_share=0.0,
                    n_ops=0, n_gaps=0, syncs={}, ops=[], gaps=[])
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
                ops=ops, gaps=gap_recs)


def timed_scalar(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Steady-state ms per call of ``fn(*args)``, which returns a 0-d
    tensor. Each call's scalar is fetched with ``.item()``, which waits
    for the work behind it; once CUDA is in use the clock is also read
    after a ``torch.cuda.synchronize()``."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args).item()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args).item()
    sync()
    return (time.perf_counter() - t0) / iters * 1000.0
