"""Device timing and bounds on the card.

Counterpart of ``groma_tpu/utils/profiling.py`` ``time_fn_ingraph``: where
the TPU timer amortises host dispatch over an in-graph loop, the card's
timer brackets each call with CUDA events, so dispatch is not counted and no
loop is needed.  ``bound`` gives the least time one H100 could take for a
function, from the bytes it must move and the operations it must do.
"""

from __future__ import annotations

import statistics
import time

import torch

L2_FLUSH_BYTES = 128 << 20      # more than the H100's 50 MB L2
# published H100 SXM peaks (NVIDIA's datasheet, dense, at 700 W)
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
PROFILED_CALLS = 5              # calls a ``Timer.split`` profiles


def bound(nbytes: float, ops: float, peak: float = H100_BF16_FLOPS):
    """(least ms, 'bytes' or 'operations') on one H100 for a function that
    must move ``nbytes`` and do ``ops`` operations of a type whose peak rate
    is ``peak``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


class Timer:
    """Device time of one call, from CUDA events: the median of ``iters``
    calls, so that one stalled call does not move it.  Before each call the
    L2 cache is overwritten (decode streams every weight and cache byte
    cold) and the stream is held by a sleep kernel, so the host's enqueue
    time is not counted."""

    def __init__(self, device='cuda'):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def __call__(self, fn, iters: int = 10, flush: bool = True,
                 clean: bool = False) -> float:
        """Median milliseconds per call of ``fn`` (warmed up once first);
        ``flush=False`` leaves in the L2 cache what the last call left.
        The flush writes its buffer, so the call also writes back the dirty
        lines it evicts (up to the L2's 50 MB); ``clean=True`` flushes by
        reading it instead, and the call finds clean lines."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if flush and clean:
                self.flush.sum()
            elif flush:
                self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def split(self, fn, per: int) -> dict:
        """``fn``'s device time by kernel, from torch.profiler over
        ``PROFILED_CALLS`` calls, each after the writing flush: ms a call of
        the kernels whose names say 'quant' ('quantizer'), of those whose
        names say 'm8_' or 'mma' and not 'epilogue' ('product'), and of the
        rest ('other': a memset, an epilogue kernel); and 'launches', the
        device operations (kernels and memsets) of each of the ``per``
        wrapper calls that one call of ``fn`` makes.  The flush's own
        kernels are not counted."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self.flush.zero_()
            torch.cuda.synchronize()
        flush_names = {e.name for e in prof.events()
                       if e.device_type.name == 'CUDA'}
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_CALLS):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        split = {'quantizer': 0.0, 'product': 0.0, 'other': 0.0,
                 'launches': 0}
        for e in prof.events():
            if e.device_type.name != 'CUDA' or e.name in flush_names:
                continue
            low = e.name.lower()
            if 'quant' in low:
                kind = 'quantizer'
            elif ('m8_' in low or 'mma' in low) and 'epilogue' not in low:
                kind = 'product'
            else:
                kind = 'other'
            split[kind] += e.device_time / 1e3 / PROFILED_CALLS
            split['launches'] += 1
        split['launches'] /= PROFILED_CALLS * per
        return split


def host_timer(fn, iters: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the host clock (CPU tensors)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def timer_for(device: str):
    """(timer, label): CUDA events on the card, the host clock on the CPU;
    the label names what was timed, for every printed number."""
    if str(device).startswith('cuda'):
        return Timer(device), torch.cuda.get_device_name(device)
    return host_timer, 'cpu, host clock: not a device time'
