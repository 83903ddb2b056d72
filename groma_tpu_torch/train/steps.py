"""Train steps (counterpart of ``groma_tpu/train/steps.py``): the VL stage's
(the CE loss of the grounded token stream) and the detection stage's (the
DDETR losses), each a forward, its backward and the optimizer's step."""

from __future__ import annotations

from typing import Callable

import torch

from groma_tpu_torch.models.ddetr_loss import ddetr_loss

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

    def step(batch: dict, generator=None) -> dict:
        out = model(images=batch['images'], input_ids=batch['input_ids'],
                    region_slot=batch['region_slot'],
                    base_valid=batch['valid'], labels=batch['labels'],
                    refer_boxes=batch.get('refer_boxes'),
                    refer_valid=batch.get('refer_valid'),
                    ground_boxes=batch.get('ground_boxes'),
                    ground_valid=batch.get('ground_valid'),
                    generator=generator, permute=permute_regions,
                    use_flash=use_flash)
        loss = out['loss']
        loss.backward()
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
    no part in the backward."""
    def step(batch: dict) -> dict:
        out = perceiver(batch['images'])
        losses = ddetr_loss(out, batch['targets'], ddetr_cfg, source,
                            matcher=matcher)
        losses['loss'].backward()
        updated = optimizer.step()
        return {**{k: v.detach() for k, v in losses.items()},
                'updated': updated}

    return step
