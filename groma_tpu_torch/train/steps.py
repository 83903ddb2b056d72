"""Train steps (counterpart of ``groma_tpu/train/steps.py``): the VL stage's
(the CE loss of the grounded token stream) and the detection stage's (the
DDETR losses), each a forward, its backward and the optimizer's step.

On the card each step runs as CUDA graphs (``utils/graphs.TrainGraph``),
the counterpart of JAX's ``jax.jit`` of the step: one set per
accumulation role (a micro-step that adds into the gradients, or a
micro-step and the update) and input shape.  The VL step is one graph.
The detection step is cut around its one host step, the Hungarian matcher
(JAX's ``pure_callback``): part A, the forward and the matcher's costs;
the matcher, whose assignment is copied into a static buffer; part C, the
losses, the backward through part A's saved activations and the update.
The auction matcher runs on the device between them, as its own graph.
No part reads a tensor back to the host: the loss comes from the device
and the ``updated`` flag from the accumulation counter.  On the CPU, and
under a process group (a gloo group's collectives run on the host; NCCL's
capture is not verified yet), the same parts run eagerly; ``step.graph``
is the step's ``TrainGraph`` and ``step.mode`` says which.

Under a process group each data rank holds a slice of the global batch
(``parallel/mesh.RankBatches``) and FSDP averages the gradients over the
data ranks, so a step divides its summed losses by the GLOBAL token or box
count and scales the backward by the data group's size: the gradient and
the reported loss are those of JAX's one program over the whole batch (a
mean of per-rank means would differ wherever the ranks' counts do).  The
tp ranks of one data rank hold the same rows and draw the same region
permutation (the generator is seeded alike on every rank), so the rank and
world here are the data group's (``model.data_group``, set by
``parallel/mesh.shard_model``), never the process group's."""

from __future__ import annotations

from typing import Callable

import torch

from groma_tpu_torch.models.ddetr_loss import (ddetr_loss, match,
                                               matcher_costs)
from groma_tpu_torch.parallel.mesh import (all_reduce_sum, grouped,
                                           rank_and_world)
from groma_tpu_torch.utils.graphs import TrainGraph

BATCH_KEYS = ('images', 'input_ids', 'region_slot', 'valid', 'labels',
              'refer_boxes', 'refer_valid', 'ground_boxes', 'ground_valid')


def batch_to(batch: dict, device) -> dict:
    """A collated numpy batch -> tensors on ``device`` (keys it lacks stay
    out)."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS
            if k in batch}


def _train_graph(module, eager: bool) -> TrainGraph:
    device = next(module.parameters()).device
    return TrainGraph(device, eager=eager or grouped())


def _mode(graph: TrainGraph) -> str:
    if graph.mode == 'captured':
        return 'captured'
    if graph.device.type == 'cuda':
        return ('eager (asked for)' if not grouped() else
                'eager (under a process group: not captured yet)')
    return 'eager (CPU)'


def make_vl_train_step(model, optimizer, use_flash: bool = False,
                       permute_regions: bool = True,
                       eager: bool = False) -> Callable:
    """-> step(batch, generator) -> {'loss': f32 scalar tensor,
    'updated': bool}.  ``batch``: ``BATCH_KEYS`` tensors, on the host or
    the device.  ``generator`` (a torch.Generator) draws the region
    permutation; each call is one micro-batch of ``optimizer``'s
    accumulation.  ``eager``: run the step eagerly on the card too (a
    step whose optimizer or model the caller instruments on the host)."""

    data = getattr(model, 'data_group', None)
    graph = _train_graph(model, eager)

    def micro(batch: dict, generator, update: bool) -> torch.Tensor:
        rank, world = rank_and_world(data)
        b = batch['images'].shape[0]
        out = model(images=batch['images'], input_ids=batch['input_ids'],
                    region_slot=batch['region_slot'],
                    base_valid=batch['valid'], labels=batch['labels'],
                    refer_boxes=batch.get('refer_boxes'),
                    refer_valid=batch.get('refer_valid'),
                    ground_boxes=batch.get('ground_boxes'),
                    ground_valid=batch.get('ground_valid'),
                    generator=generator, permute=permute_regions,
                    use_flash=use_flash,
                    permute_rows=(rank * b, world * b))
        n = all_reduce_sum(out['n_tokens'].float(), data).clamp(min=1)
        (out['nll_sum'] * (world / n)).backward()
        loss = all_reduce_sum(out['nll_sum'].detach() / n, data)
        if update:
            optimizer.update()
        return loss

    def step(batch: dict, generator=None) -> dict:
        optimizer.prepare()
        update = optimizer.tick()
        loss = graph.run(
            (lambda b: micro(b, generator, update),), batch,
            key=(update, id(generator)),
            generators=() if generator is None else (generator,))
        return {'loss': loss, 'updated': update}

    step.graph = graph
    step.mode = _mode(graph)
    return step


DET_TARGET_KEYS = ('class_labels', 'boxes', 'valid')


def det_batch_to(batch: dict, device) -> dict:
    """A collated detection batch (``collate_det``) -> {'images',
    'targets'} tensors on ``device``."""
    return {'images': torch.as_tensor(batch['images']).to(device),
            'targets': {k: torch.as_tensor(batch['targets'][k]).to(device)
                        for k in DET_TARGET_KEYS}}


def make_det_train_step(perceiver, ddetr_cfg, optimizer, source: str,
                        matcher: str = 'hungarian',
                        eager: bool = False) -> Callable:
    """-> step(batch) -> the loss dict (0-d tensors), 'updated' added.
    ``batch``: ``det_batch_to``'s layout, on the host or the device.
    ``source`` ('coco' | 'sa1b') picks the objectness head, as every batch
    is single-source; ``matcher`` 'hungarian' or 'auction'.  The forward
    has no dropout (JAX's ``deterministic=True``); frozen parameters take
    no part in the backward.  Across ranks the losses are normalized by
    the global box count and summed over the ranks (the cardinality
    error, a mean over images, averaged).  ``eager``: as for
    ``make_vl_train_step``."""
    data = getattr(perceiver, 'data_group', None)
    graph = _train_graph(perceiver, eager)
    keys = []               # the loss dict's keys, set by the first run

    def targets(inputs):
        return {k: inputs[k] for k in DET_TARGET_KEYS}

    def forward(inputs):                                      # part A
        out = perceiver(inputs['images'])
        return {'out': out, 'costs': matcher_costs(
            out, targets(inputs), ddetr_cfg, source)}

    def assign(a):                                            # the host
        return match(a['costs'], matcher)

    def loss_update(inputs, a, assigned, update: bool):      # part C
        _, world = rank_and_world(data)
        num_boxes = all_reduce_sum(
            inputs['valid'].sum().to(torch.float32), data)
        losses = ddetr_loss(a['out'], targets(inputs), ddetr_cfg, source,
                            matcher=matcher, num_boxes=num_boxes,
                            assign=assigned)
        (losses['loss'] * world).backward()
        keys[:] = list(losses)
        total = all_reduce_sum(torch.stack(
            [losses[k].detach() for k in keys]), data)
        if update:
            optimizer.update()
        # the cardinality error is a mean over images: averaged
        return torch.stack([v / world if k.startswith('cardinality_error')
                            else v for k, v in zip(keys, total)])

    def step(batch: dict) -> dict:
        optimizer.prepare()
        update = optimizer.tick()
        inputs = {'images': batch['images'], **batch['targets']}
        total = graph.run(
            (forward, lambda i, a, h: loss_update(i, a, h, update)),
            inputs, key=(update,), host=assign)
        return {**dict(zip(keys, total)), 'updated': update}

    step.graph = graph
    step.mode = _mode(graph)
    return step
