"""Decode loops as one device program: a loop's step captured once as a
CUDA graph and replayed, the counterpart of ``jax.jit`` over a
``lax.scan`` body.

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
that ran on the device.
"""

from __future__ import annotations

from collections import Counter

import torch


def launch_counts() -> dict:
    """Every decode-path kernel wrapper's launch counter, by name."""
    from groma_tpu_torch.ops.decode_attention import int8_decode_attention
    from groma_tpu_torch.ops.decode_megakernel import fused_decode_step
    from groma_tpu_torch.ops.paged_attention import \
        paged_int8_decode_attention
    from groma_tpu_torch.ops.quant import int8_matmul
    from groma_tpu_torch.ops.quant4 import int4_matmul
    return {'int8_matmul': int8_matmul.launches,
            'int8_matmul.prefill': int8_matmul.prefill_launches,
            'int4_matmul': int4_matmul.launches,
            'int4_matmul.prefill': int4_matmul.prefill_launches,
            'int8_decode_attention': int8_decode_attention.launches,
            'paged_int8_decode_attention':
                paged_int8_decode_attention.launches,
            'decode_megakernel': fused_decode_step.launches}


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
