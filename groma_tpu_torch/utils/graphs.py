"""Decode loops and prefills as device programs: a loop's step captured
once as a CUDA graph and replayed, the counterpart of ``jax.jit`` over a
``lax.scan`` body (``StepGraph``), and a call captured once per input
shape, the counterpart of ``jax.jit``'s cache of compiled programs
(``CallGraph``, the prefills).

A step is a function of its state, ``step(state)``: the state is a dict
(lists and dicts nested in it allowed) of tensors that the step reads and
writes in place and that outlive the graph.  The step reads nothing back
to the host and copies nothing from it, so what a replay does depends on
the state's contents only, never on a Python value that the capture would
bake in: a position, a slot or a step counter is a device tensor of the
state, advanced in place.

``StepGraph.run(n)`` advances the loop n steps.  On the CPU (the tests) it
calls the step n times.  On the card, the first step of a new StepGraph
runs eagerly on the device's capture stream, so that every library,
workspace and handle the step reaches lazily exists before the capture
(the kernels keep their split-K workspaces per (device, stream), and the
kernel library builds with nvcc at first use); the next step is captured
on that stream and every step from then on is a replay.  A capture that
fails raises: there is no eager fallback on the card.

A step that runs a gloo collective (tensor parallelism over a gloo group,
``parallel/tensor_parallel``: gloo moves a CUDA tensor through the host)
cannot be captured: its owner asks for ``eager=True`` up front, and every
step then runs eagerly on the card, as on the CPU.  NCCL's collectives are
captured like any kernel.

Launch counts: a kernel wrapper's counter moves when the wrapper is
called, eagerly or while a step is captured, never when a graph replays.
``StepGraph.delta`` is each counter's move during the capture, the
launches of one replay.  The class-level tallies ``StepGraph.captured``
and ``StepGraph.replayed`` add up, over every graph since
``StepGraph.reset_tally()``, those moves and delta x replays, and
``StepGraph.device_launches(counts)`` turns wrapper counts into launches
that ran on the device.  A ``CallGraph`` adds its captures and replays to
the same tallies; its warm-up calls ran on the device and stay counted
(``CallGraph.warmups`` counts them).
"""

from __future__ import annotations

import time
from collections import Counter

import torch


def launch_counts() -> dict:
    """Every inference-path wrapper's launch counter, by name: the decode
    and prefill kernels, the flash forward by mask, and the W8A8 library
    routes (``torch._int_mm`` calls)."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    from groma_tpu_torch.ops.flash_attention import flash_fwd
    from groma_tpu_torch.ops.paged_attention import \
        paged_int8_decode_attention
    from groma_tpu_torch.ops.quant import int8_matmul, w8a8_conv, w8a8_matmul
    from groma_tpu_torch.ops.quant4 import int4_matmul
    return {'int8_matmul': int8_matmul.launches,
            'int8_matmul.prefill': int8_matmul.prefill_launches,
            'int4_matmul': int4_matmul.launches,
            'int4_matmul.prefill': int4_matmul.prefill_launches,
            'int8_decode_attention': int8_decode_attention.launches,
            'paged_int8_decode_attention':
                paged_int8_decode_attention.launches,
            'decode_megakernel': fused_decode_step.launches,
            'flash_fwd.causal': flash_fwd.launches['causal'],
            'flash_fwd.bidirectional': flash_fwd.launches['bidirectional'],
            'w8a8_matmul': w8a8_matmul.launches,
            'w8a8_conv': w8a8_conv.launches}


def set_launch_counts(counts: dict):
    """Put every wrapper's launch counter named in ``counts`` (the keys of
    ``launch_counts()``) back to its value there."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    from groma_tpu_torch.ops.flash_attention import flash_fwd
    from groma_tpu_torch.ops.paged_attention import \
        paged_int8_decode_attention
    from groma_tpu_torch.ops.quant import int8_matmul, w8a8_conv, w8a8_matmul
    from groma_tpu_torch.ops.quant4 import int4_matmul
    for name, v in counts.items():
        if name.startswith('flash_fwd.'):
            flash_fwd.launches[name.split('.')[1]] = v
            continue
        wrapper, _, attr = name.partition('.')
        fn = {'int8_matmul': int8_matmul, 'int4_matmul': int4_matmul,
              'int8_decode_attention': int8_decode_attention,
              'paged_int8_decode_attention': paged_int8_decode_attention,
              'decode_megakernel': fused_decode_step,
              'w8a8_matmul': w8a8_matmul, 'w8a8_conv': w8a8_conv}[wrapper]
        setattr(fn, f'{attr}_launches' if attr else 'launches', v)


def _on_card(tensor) -> bool:
    """Whether calls on ``tensor``'s device are captured (CUDA)."""
    return tensor.device.type == 'cuda'


def _tensors(tree):
    """The tensors of a state: a tensor, or dicts and lists of them."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (dict, list, tuple)):
        for item in tree.values() if isinstance(tree, dict) else tree:
            yield from _tensors(item)


# device index -> the stream that warms up and captures every step graph
_capture_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every warm-up and capture, so that
    the workspaces kept per (device, stream) are made once, eagerly."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(device=index)
    return _capture_streams[index]


class StepGraph:
    """A decode loop's step over its static state: eager on the CPU, one
    warm-up step, one capture and replays on the card.

    ``generators``: the CUDA ``torch.Generator`` objects the step draws
    from, registered with the graph so that each replay advances them as
    an eager step would.  ``eager``: never capture (a step with a host-side
    collective)."""

    captured: Counter = Counter()   # counter moves at capture, all graphs
    replayed: Counter = Counter()   # delta x replays, all graphs

    def __init__(self, step, state: dict, generators=(),
                 eager: bool = False):
        tensor = next(_tensors(state), None)
        if tensor is None:
            raise ValueError('StepGraph: the state holds no tensor')
        self.step = step
        self.state = state
        self.device = tensor.device
        self.generators = tuple(generators)
        self.eager = eager
        self.graph = None
        self.warm = False
        self.delta: dict = {}

    @classmethod
    def reset_tally(cls):
        cls.captured.clear()
        cls.replayed.clear()
        CallGraph.warmups = 0

    @classmethod
    def device_launches(cls, counts: dict) -> dict:
        """Wrapper counts (``launch_counts()``, taken since the last
        ``reset_tally``) -> launches that ran: the capture-time calls
        out, the replays' in."""
        return {k: v - cls.captured[k] + cls.replayed[k]
                for k, v in counts.items()}

    def run(self, n: int):
        """Advance the loop ``n`` steps."""
        if self.device.type != 'cuda' or self.eager:
            for _ in range(n):
                self.step(self.state)
            return
        stream = capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        if n > 0 and not self.warm:
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.step(self.state)
            current.wait_stream(stream)
            self.warm = True
            n -= 1
        if n > 0 and self.graph is None:
            self._capture(stream)
        for _ in range(n):
            self.graph.replay()
        for k, v in self.delta.items():
            StepGraph.replayed[k] += v * n

    def _capture(self, stream):
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = launch_counts()
        # thread_local: a request or scheduler thread captures while
        # others may allocate
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode='thread_local'):
            self.step(self.state)
        after = launch_counts()
        self.delta = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        StepGraph.captured.update(self.delta)
        self.graph = graph


def _signature(inputs) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in inputs)


class _Captured:
    """One key's graph: its state, its static inputs, the capture's
    outputs, the counter moves of one replay, the capture's host ms and
    the bytes its capture added to the pool."""

    def __init__(self, graph, state, inputs, outputs, delta, capture_ms,
                 pool_bytes):
        self.graph = graph
        self.state = state
        self.inputs = inputs
        self.outputs = outputs
        self.delta = delta
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.replays = 0


class CallGraph:
    """One function's CUDA graphs, one per key: the counterpart of
    ``jax.jit``'s cache of compiled programs, for a call made once per
    request (a prefill) rather than in a loop.

    ``run(fn, state, *inputs, key=())`` returns ``fn(state, *inputs)``.
    Each input is a tensor or None; ``state`` (a tree of tensors, or None)
    is what ``fn`` writes or reads in place and what outlives the graph
    (a generator's KV cache).  The graph's key is ``key`` (the owner's
    flags), the state object and the shape and dtype of every input;
    ``fn`` is the key's at its first call.

    On the CPU, or with ``eager=True`` (a gloo tp group's collectives run
    on the host), ``fn`` runs eagerly.  On the card a key's first call
    copies its inputs into static buffers, runs ``fn`` once on
    ``capture_stream(device)`` (the warm-up: the kernel library's build,
    ``cudaFuncSetAttribute``, the split-K workspaces of that stream, the
    library handles), captures it on that stream and replays it, so that
    even the first result comes from a replay; every later call of the key
    copies its inputs in and replays.  A capture that fails raises: there
    is no eager fallback on the card.  Every graph of one ``CallGraph``
    shares one memory pool (``torch.cuda.graph_pool_handle``); their
    replays run in stream order, never at once.

    The outputs are the capture's tensors: the key's next replay
    overwrites them, so a caller copies out what it keeps.  What ``fn``
    does on the host (a Python value it sets, a wrapper's launch counter)
    happens at the warm-up and the capture only: the caller redoes it
    after each run.  ``keep``: how many keys are kept, the least recently
    run dropped first (its graph and the state it held freed), as
    ``jax.jit`` would compile anew for a new shape.

    Launches: as ``StepGraph``'s, the capture's counter moves (``delta``)
    go to ``StepGraph.captured`` and every replay's to
    ``StepGraph.replayed``; the warm-up's stay in the wrappers' counts, and
    ``CallGraph.warmups`` counts warm-ups since ``StepGraph.reset_tally``.
    """

    warmups = 0

    def __init__(self, keep: int = 1, eager: bool = False):
        self.keep = keep
        self.eager = eager
        self.entries: dict = {}    # key -> _Captured, least recent first
        self.pool = None
        self.mode = None           # 'captured' or 'eager', of the last run

    def run(self, fn, state, *inputs, key=()):
        tensor = next(_tensors([state, *inputs]), None)
        if tensor is None or not _on_card(tensor) or self.eager:
            self.mode = 'eager'
            return fn(state, *inputs)
        self.mode = 'captured'
        # the entry holds its state: while it lives, no other state can
        # take its id
        full = (key, id(state), _signature(inputs))
        entry = self.entries.pop(full, None)
        if entry is None:
            while self.entries and len(self.entries) >= self.keep:
                self.entries.pop(next(iter(self.entries)))
            entry = self._capture(fn, state, inputs, tensor.device)
        else:
            for dst, src in zip(_tensors(entry.inputs), _tensors(inputs)):
                dst.copy_(src)
        self.entries[full] = entry
        entry.graph.replay()
        entry.replays += 1
        for k, v in entry.delta.items():
            StepGraph.replayed[k] += v
        return entry.outputs

    def _capture(self, fn, state, inputs, device) -> _Captured:
        static = tuple(None if t is None else t.clone() for t in inputs)
        stream = capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn(state, *static)                           # the warm-up
        current.wait_stream(stream)
        CallGraph.warmups += 1
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        t0 = time.perf_counter()
        # thread_local: the engine's scheduler thread captures while
        # request threads may allocate
        with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                              capture_error_mode='thread_local'):
            reserved = torch.cuda.memory_reserved(device)
            outputs = fn(state, *static)
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
        capture_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        StepGraph.captured.update(delta)
        return _Captured(graph, state, static, outputs, delta, capture_ms,
                         pool_bytes)
