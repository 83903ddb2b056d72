"""Train steps (counterpart of ``groma_tpu/train/steps.py``): the VL stage's
(the CE loss of the grounded token stream) and the detection stage's (the
DDETR losses), each a forward, its backward and the optimizer's step.

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

from groma_tpu_torch.models.ddetr_loss import ddetr_loss
from groma_tpu_torch.parallel.mesh import all_reduce_sum, rank_and_world

BATCH_KEYS = ('images', 'input_ids', 'region_slot', 'valid', 'labels',
              'refer_boxes', 'refer_valid', 'ground_boxes', 'ground_valid')


def batch_to(batch: dict, device) -> dict:
    """A collated numpy batch -> tensors on ``device`` (keys it lacks stay
    out)."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS
            if k in batch}


def make_vl_train_step(model, optimizer, use_flash: bool = False,
                       permute_regions: bool = True) -> Callable:
    """-> step(batch, generator) -> {'loss': f32 scalar tensor,
    'updated': bool}.  ``generator`` (a torch.Generator) draws the region
    permutation; each call is one micro-batch of ``optimizer``'s
    accumulation."""

    data = getattr(model, 'data_group', None)

    def step(batch: dict, generator=None) -> dict:
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
        updated = optimizer.step()
        return {'loss': loss.detach(), 'updated': updated}

    return step


DET_TARGET_KEYS = ('class_labels', 'boxes', 'valid')


def det_batch_to(batch: dict, device) -> dict:
    """A collated detection batch (``collate_det``) -> {'images',
    'targets'} tensors on ``device``."""
    return {'images': torch.as_tensor(batch['images']).to(device),
            'targets': {k: torch.as_tensor(batch['targets'][k]).to(device)
                        for k in DET_TARGET_KEYS}}


def make_det_train_step(perceiver, ddetr_cfg, optimizer, source: str,
                        matcher: str = 'hungarian') -> Callable:
    """-> step(batch) -> the loss dict (detached), 'updated' added.
    ``source`` ('coco' | 'sa1b') picks the objectness head, as every batch
    is single-source; ``matcher`` 'hungarian' or 'auction'.  The forward
    has no dropout (JAX's ``deterministic=True``); frozen parameters take
    no part in the backward.  Across ranks the losses are normalized by
    the global box count and summed over the ranks (the cardinality
    error, a mean over images, averaged)."""
    data = getattr(perceiver, 'data_group', None)

    def step(batch: dict) -> dict:
        _, world = rank_and_world(data)
        out = perceiver(batch['images'])
        num_boxes = all_reduce_sum(
            batch['targets']['valid'].sum().to(torch.float32), data)
        losses = ddetr_loss(out, batch['targets'], ddetr_cfg, source,
                            matcher=matcher, num_boxes=num_boxes)
        (losses['loss'] * world).backward()
        keys = list(losses)
        total = all_reduce_sum(torch.stack(
            [losses[k].detach() for k in keys]), data)
        losses = {k: v / world if k.startswith('cardinality_error')
                  else v for k, v in zip(keys, total)}
        updated = optimizer.step()
        return {**{k: v.detach() for k, v in losses.items()},
                'updated': updated}

    return step
