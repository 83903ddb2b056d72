"""The traced window: ``torch.profiler`` over part of the measured window,
reduced to what the per-layer readers and the result line take.

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or set) ran, inside the window;
* ``kernel_s``: device seconds by operation name;
* ``device_ops``: the ten operations with the most device time;
* ``idle_gaps``: the ten longest gaps with no device operation, each named
  by what the host was doing at its middle: 'in <op>' for the longest
  host operation under way then (the CUDA runtime calls of every thread,
  the operators of the thread that traces), else 'after <op>' for the
  last one that had ended.

The window's ends are two marks the benchmark records on the host
(``portbench.trace_open`` / ``portbench.trace_close``), so the device's
times and the host's share one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import torch

OPEN, CLOSE = 'portbench.trace_open', 'portbench.trace_close'
TOP = 10
# the trace's categories: what ran on the device, and what the host did
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_KINDS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


class Trace:
    """The profiler over one stretch of a run.  While it starts and while
    it stops, every thread's CUDA-graph launches wait at a gate and the
    device is drained: on the card, stopping CUPTI while another thread
    was inside a graph launch deadlocked the process (one stop in three)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t_open = self.t_close = None
        self.gate = threading.Lock()
        self.replay = None

    def _quiet(self, step):
        with self.gate:
            if self.cuda:
                torch.cuda.synchronize()
            step()

    def open(self):
        if self.cuda:
            self.replay = replay = torch.cuda.CUDAGraph.replay
            gate = self.gate

            def gated(graph):
                with gate:
                    return replay(graph)
            torch.cuda.CUDAGraph.replay = gated
        self._quiet(self.prof.__enter__)
        with torch.profiler.record_function(OPEN):
            self.t_open = time.perf_counter()

    def close(self):
        with torch.profiler.record_function(CLOSE):
            self.t_close = time.perf_counter()
        self._quiet(lambda: self.prof.__exit__(None, None, None))
        if self.replay is not None:
            torch.cuda.CUDAGraph.replay = self.replay

    def reduce(self) -> dict:
        """Read the trace back through its Chrome-trace export (the one
        form every version of the profiler writes alike)."""
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.unlink(path)
        host, device = [], []
        lo = hi = None
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat, name = e.get('cat', ''), e.get('name', '')
            start = float(e['ts']) * 1e3
            end = start + float(e.get('dur', 0)) * 1e3
            if cat in DEVICE_KINDS:
                device.append((start, end, name))
            elif cat not in HOST_KINDS:
                continue
            elif name == OPEN:
                lo = start
            elif name == CLOSE:
                hi = end
            else:
                host.append((start, end, name))
        if lo is None or hi is None:
            raise RuntimeError('the trace lost its window marks')
        return reduce_events(device, host, lo, hi)


def reduce_events(device, host, lo, hi) -> dict:
    """(start_ns, end_ns, name) device and host events, the window
    [lo, hi] -> the reduction (see the module's docstring)."""
    spans = sorted((max(s, lo), min(e, hi), n) for s, e, n in device
                   if e > lo and s < hi)
    by_name = {}
    for s, e, n in spans:
        by_name[n] = by_name.get(n, 0) + (e - s)
    merged = []
    for s, e, _ in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((s - at, at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((hi - at, at, hi))
    gaps.sort(reverse=True)
    named = []
    for length, s, e in gaps[:TOP]:
        mid = (s + e) / 2
        over = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        before = [(he, n) for hs, he, n in host if he < mid]
        if over:
            what = 'in ' + max(over)[1]
        elif before:
            what = 'after ' + max(before)[1]
        else:
            what = 'host: no traced op'
        named.append([what[:160], length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {'window_s': (hi - lo) / 1e9, 'busy_s': busy / 1e9,
            'kernel_s': {n: t / 1e9 for n, t in by_name.items()},
            'device_ops': [[n[:160], t / 1e9] for n, t in ops],
            'idle_gaps': named}


def kernel_seconds(red: dict, name: str) -> float:
    """Device seconds of the operations whose name holds ``name``."""
    return sum(t for n, t in red['kernel_s'].items() if name in n)
