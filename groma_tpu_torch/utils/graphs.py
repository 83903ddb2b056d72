"""Decode loops, prefills and training steps as device programs: a loop's
step captured once as a CUDA graph and replayed, the counterpart of
``jax.jit`` over a ``lax.scan`` body (``StepGraph``), a call captured once
per input shape, the counterpart of ``jax.jit``'s cache of compiled
programs (``CallGraph``, the prefills and the detector's evaluation), and
a training step with its backward and update, captured per key in parts
cut where the host must act (``TrainGraph``).

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
    """Every wrapper's launch counter, by name: the decode and prefill
    kernels, the flash forward and backward by mask, and the W8A8 library
    routes (``torch._int_mm`` calls)."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    from groma_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
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
            'flash_bwd.causal': flash_bwd.launches['causal'],
            'flash_bwd.bidirectional': flash_bwd.launches['bidirectional'],
            'w8a8_matmul': w8a8_matmul.launches,
            'w8a8_conv': w8a8_conv.launches}


def set_launch_counts(counts: dict):
    """Put every wrapper's launch counter named in ``counts`` (the keys of
    ``launch_counts()``) back to its value there."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    from groma_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from groma_tpu_torch.ops.paged_attention import \
        paged_int8_decode_attention
    from groma_tpu_torch.ops.quant import int8_matmul, w8a8_conv, w8a8_matmul
    from groma_tpu_torch.ops.quant4 import int4_matmul
    for name, v in counts.items():
        if name.startswith(('flash_fwd.', 'flash_bwd.')):
            flash, mask = name.split('.')
            (flash_fwd if flash == 'flash_fwd' else flash_bwd).launches[
                mask] = v
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


class _Entry:
    """One key's graphs (``CallGraph``'s and ``TrainGraph``'s): the static
    inputs (a training step's with their pinned host staging), the state,
    one graph per part, each part's outputs, the static buffers of each
    host step's results, the counter moves of one replay, the capture's
    host ms and the bytes its captures added to the pool."""

    def __init__(self, inputs, state=None, pinned=None):
        self.inputs = inputs
        self.state = state
        self.pinned = pinned or {}
        self.staged = None          # event: the last copy out of `pinned`
        self.graphs, self.outputs, self.extras = [], [], []
        self.delta: dict = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def load(self, inputs):
        """Copy ``inputs`` (a dict or a sequence, as the static ones) into
        the static buffers: a host tensor through its pinned staging buffer
        (once the last step's copy out of it has run), a device tensor
        directly."""
        if self.staged is not None:
            self.staged.synchronize()
        pairs = inputs.items() if isinstance(inputs, dict) else \
            enumerate(inputs)
        for k, src in pairs:
            dst = self.inputs[k]
            if dst is None:
                continue
            if k in self.pinned:
                self.pinned[k].copy_(src)
                dst.copy_(self.pinned[k], non_blocking=True)
            else:
                dst.copy_(src)
        if self.pinned:
            self.staged = torch.cuda.Event()
            self.staged.record()

    def capture(self, calls, pool, device, generators=()):
        """Capture ``calls`` in order on ``capture_stream(device)`` into
        ``pool``, one graph each (``calls[i](previous output)``), and count
        the launches they make (``StepGraph.captured``)."""
        stream = capture_stream(device)
        before = launch_counts()
        t0 = time.perf_counter()
        out = None
        for call in calls:
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            # thread_local: a request, scheduler or loader thread may
            # allocate meanwhile; the context emptied the allocator's cache
            # first, so the reserved bytes' growth is the pool's
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode='thread_local'):
                reserved = torch.cuda.memory_reserved(device)
                out = call(out)
                self.pool_bytes += torch.cuda.memory_reserved(device) \
                    - reserved
            self.graphs.append(graph)
            self.outputs.append(out)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        self.delta = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        StepGraph.captured.update(self.delta)

    def replay(self, host=None):
        """Replay the parts, ``host`` and a copy of its results into the
        static buffers between two; count the replay's launches."""
        for i, graph in enumerate(self.graphs):
            if i:
                extra = host(self.outputs[i - 1])
                for dst, src in zip(_tensors(self.extras[i - 1]),
                                    _tensors(extra)):
                    dst.copy_(src)
            graph.replay()
        self.replays += 1
        for k, v in self.delta.items():
            StepGraph.replayed[k] += v
        return self.outputs[-1]


def _warm_up(device, fn):
    """``fn()`` on ``capture_stream(device)``, in order with the current
    stream: every lazily built kernel, workspace and handle it reaches is
    made before a capture."""
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


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
        self.entries: dict = {}    # key -> _Entry, least recent first
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
            entry = _Entry(tuple(None if t is None else t.clone()
                                 for t in inputs), state)
            _warm_up(tensor.device, lambda: fn(state, *entry.inputs))
            CallGraph.warmups += 1
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            entry.capture([lambda _: fn(state, *entry.inputs)], self.pool,
                          tensor.device)
        else:
            entry.load(inputs)
        self.entries[full] = entry
        return entry.replay()


def _chain(parts, inputs, host):
    """The parts of a step one after another -> (each host step's
    results, the last part's output)."""
    out = parts[0](inputs)
    extras = []
    for part in parts[1:]:
        extras.append(host(out))
        out = part(inputs, out, extras[-1])
    return extras, out


class TrainGraph:
    """A training step as CUDA graphs, the counterpart of ``jax.jit`` over
    a train step: one set of graphs per key, as ``jax.jit`` keeps one
    program per static argument and input shape.

    ``run(parts, inputs, key=(), host=None, generators=())`` runs one step
    and returns the last part's output.  ``inputs`` is a flat dict of
    tensors, on the host or the device.  ``parts[0](inputs)`` is the first
    part; a step of more parts is cut where the host must act (the
    detection step's Hungarian matcher): ``host(out)`` takes the previous
    part's output and returns a tree of device tensors, and
    ``parts[i](inputs, out, extra)`` continues from both.  A part runs
    autograd: its backward may go through an earlier part's forward.
    ``generators``: the CUDA ``torch.Generator`` objects the step draws
    from, registered with every graph so that each replay advances them as
    an eager step would.

    On the CPU, or with ``eager=True`` (under a process group), the parts
    run eagerly on the device's tensors.  On the card a key's first call
    copies its inputs into static buffers and runs the step eagerly on
    ``capture_stream(device)`` (the warm-up, which is this call's step: it
    makes every lazily built kernel, workspace and handle, and its result
    is returned); then each part is captured on that stream into the
    graph's one memory pool, in order, so that a later part's backward
    records the kernels of the earlier part's saved activations, which
    every replay of the earlier part rewrites in place (as
    ``torch.cuda.make_graphed_callables`` shares one pool between a
    forward and its backward).  Every later call copies its inputs in
    (host tensors through pinned staging buffers) and replays the parts,
    with the host step and a copy of its results into static buffers
    between them.  A capture that fails raises: there is no eager
    fallback on the card.

    The outputs are the capture's tensors, which the key's next replay
    overwrites: a caller copies out what it keeps.  What the parts do on
    the host happens at the warm-up and the capture only.  Launches are
    counted as ``CallGraph``'s: the capture's counter moves go to
    ``StepGraph.captured``, each replay's to ``StepGraph.replayed``; the
    warm-up's ran and stay in the wrappers' counts."""

    def __init__(self, device, eager: bool = False):
        self.device = torch.device(device)
        self.eager = eager or self.device.type != 'cuda'
        self.entries: dict = {}    # key -> _Entry
        self.pool = None

    @property
    def mode(self) -> str:
        return 'eager' if self.eager else 'captured'

    def run(self, parts, inputs: dict, key=(), host=None, generators=()):
        if self.eager:
            inputs = {k: v.to(self.device) for k, v in inputs.items()}
            return _chain(parts, inputs, host)[1]
        full = (key, tuple((k, tuple(v.shape), v.dtype)
                           for k, v in inputs.items()))
        entry = self.entries.get(full)
        if entry is not None:
            entry.load(inputs)
            return entry.replay(host)
        entry = _Entry(
            {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
             for k, v in inputs.items()}, pinned={
                k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in inputs.items() if v.device.type == 'cpu'})
        entry.load(inputs)
        static = entry.inputs
        extras, first = _warm_up(self.device,
                                 lambda: _chain(parts, static, host))
        entry.extras = [_clone(e) for e in extras]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        entry.capture(
            [lambda _: parts[0](static)] + [
                lambda out, part=part, extra=extra: part(static, out, extra)
                for part, extra in zip(parts[1:], entry.extras)],
            self.pool, self.device, generators)
        # the replays need the outputs' memory, not their autograd graph:
        # kept alive, it would hold each parameter's gradient accumulator
        # on the capture stream for every later eager step
        entry.outputs = [_detached(o) for o in entry.outputs]
        self.entries[full] = entry
        return first

    def report(self) -> dict:
        """mode, and over the keys captured: capture ms, pool GiB, replays
        and the launches of one replay, by key."""
        return {'mode': self.mode,
                'capture_ms': sum(e.capture_ms
                                  for e in self.entries.values()),
                'pool_gib': sum(e.pool_bytes
                                for e in self.entries.values()) / 2**30,
                'replays': sum(e.replays for e in self.entries.values()),
                'launches': {k[0]: dict(e.delta)
                             for k, e in self.entries.items()}}


def _detached(tree):
    if torch.is_tensor(tree):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]
