"""Deformable-DETR training losses (counterpart of
``groma_tpu/models/ddetr_loss.py``).

Sigmoid focal CE (HF ``sigmoid_focal_loss`` semantics) + L1 + GIoU over
matched pairs, for the last decoder layer, each earlier layer (``_0`` to
``_{L-2}``) and the encoder's proposals with binarized labels (``_enc``);
the total weights every ``loss_ce*``, ``loss_bbox*`` and ``loss_giou*``
by its coefficient.  Targets are fixed-capacity padded tensors
(class_labels (B, T), boxes (B, T, 4) normalized cxcywh, valid (B, T));
``num_boxes`` is the batch's target count, clamped to at least 1 (a
data-parallel step passes the global batch's).
The stages with one query count share one matcher call over their stacked
costs; ``matcher_costs`` and ``match`` split that call out, so that a
train step can run the matcher between a captured forward and a captured
loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from groma_tpu_torch.config import DDETRConfig
from groma_tpu_torch.ops.bbox import (cxcywh_to_xyxy,
                                      elementwise_generalized_box_iou,
                                      generalized_box_iou)
from groma_tpu_torch.ops.matcher import auction_match, hungarian_match

MATCHERS = {'hungarian': hungarian_match, 'auction': auction_match}


def _matcher_cost(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                  cfg: DDETRConfig, alpha=0.25, gamma=2.0):
    """(B, Q, T) matching cost, HF DeformableDetrHungarianMatcher math;
    1e8 on padded targets."""
    prob = torch.sigmoid(logits.to(torch.float32))            # (B, Q, C)
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    b, q, _ = prob.shape
    idx = tgt_labels[:, None, :].expand(b, q, -1).to(torch.int64)
    cls_cost = pos.gather(2, idx) - neg.gather(2, idx)
    bbox_cost = (pred_boxes[:, :, None, :]
                 - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou_cost = -generalized_box_iou(cxcywh_to_xyxy(pred_boxes),
                                     cxcywh_to_xyxy(tgt_boxes))
    cost = (cfg.bbox_cost * bbox_cost + cfg.class_cost * cls_cost
            + cfg.giou_cost * giou_cost)
    return torch.where(tgt_valid[:, None, :], cost, 1e8)


def _single_stage_loss(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                       num_boxes, cfg: DDETRConfig, matcher='hungarian',
                       assign=None) -> Dict[str, torch.Tensor]:
    """loss_ce / loss_bbox / loss_giou / cardinality_error of one prediction
    set; ``assign`` (B, T) from the matcher, computed here when None."""
    b, q, ncls = logits.shape
    if assign is None:
        cost = _matcher_cost(logits, pred_boxes, tgt_labels, tgt_boxes,
                             tgt_valid, cfg, alpha=cfg.focal_alpha)
        assign = MATCHERS[matcher](cost.detach(), tgt_valid)
    assign_safe = assign.clamp(min=0)

    # focal classification: mean over queries, sum over batch and classes,
    # / num_boxes, * Q
    tgt_cls = torch.where(tgt_valid, tgt_labels, 0).to(torch.int64)
    updates = torch.nn.functional.one_hot(tgt_cls, ncls).to(torch.float32) \
        * tgt_valid[..., None]
    onehot = torch.zeros((b, q, ncls), dtype=torch.float32,
                         device=logits.device).scatter_add(
        1, assign_safe[..., None].expand(-1, -1, ncls), updates)
    onehot = onehot.clamp(0.0, 1.0)
    logits32 = logits.to(torch.float32)
    prob = torch.sigmoid(logits32)
    ce = (logits32.clamp(min=0) - logits32 * onehot
          + torch.log1p(torch.exp(-logits32.abs())))
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * (1 - p_t) ** 2.0
    alpha_t = cfg.focal_alpha * onehot + (1 - cfg.focal_alpha) * (1 - onehot)
    loss = alpha_t * loss
    loss_ce = loss.mean(dim=1).sum() / num_boxes * q

    # box losses over matched pairs
    src_boxes = pred_boxes.gather(1, assign_safe[..., None].expand(-1, -1, 4))
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = torch.where(tgt_valid, l1, 0.0).sum() / num_boxes
    giou = elementwise_generalized_box_iou(cxcywh_to_xyxy(src_boxes),
                                           cxcywh_to_xyxy(tgt_boxes))
    loss_giou = torch.where(tgt_valid, 1.0 - giou, 0.0).sum() / num_boxes

    # logged only: HF's loss_cardinality counts argmax != the last class,
    # always 0 with one class, as in the reference's class-agnostic runs
    card_pred = (logits32.argmax(-1) != ncls - 1).sum(1).to(torch.float32)
    n_tgt = tgt_valid.sum(1).to(torch.float32)
    cardinality_error = (card_pred - n_tgt).abs().mean()
    return {'loss_ce': loss_ce, 'loss_bbox': loss_bbox,
            'loss_giou': loss_giou, 'cardinality_error': cardinality_error}


def _stages(outputs: Dict, tgt_labels, cfg: DDETRConfig, source: str):
    """(suffix, logits, boxes, labels) of every supervised prediction
    set."""
    stages = [('', outputs['logits'][source], outputs['pred_boxes'],
               tgt_labels)]
    if cfg.auxiliary_loss:
        for i, (lg, bx) in enumerate(zip(outputs['aux'][source],
                                         outputs['aux']['boxes'])):
            stages.append((f'_{i}', lg, bx, tgt_labels))
    if cfg.two_stage:
        # the encoder's proposals against binary targets (class 0)
        stages.append(('_enc', outputs['enc_outputs_class'],
                       outputs['enc_outputs_coord'],
                       torch.zeros_like(tgt_labels)))
    return stages


def _groups(stages) -> list:
    """The stages' indices by query count, one matcher call each (the
    encoder stage proposes over every encoder token, not num_queries)."""
    groups: Dict[int, list] = {}
    for k, st in enumerate(stages):
        groups.setdefault(st[1].shape[1], []).append(k)
    return list(groups.values())


@torch.no_grad()
def matcher_costs(outputs: Dict, targets: Dict, cfg: DDETRConfig,
                  source: str) -> list:
    """The matcher's inputs, one (cost (S*B, Q, T), validity (S*B, T))
    pair per query count: the S stages of that count stacked.  Device
    work only: a CUDA graph captures it with the forward."""
    tgt_boxes = targets['boxes'].to(torch.float32)
    tgt_valid = targets['valid'].to(torch.bool)
    stages = _stages(outputs, targets['class_labels'], cfg, source)
    out = []
    for idxs in _groups(stages):
        costs = torch.stack([
            _matcher_cost(stages[k][1], stages[k][2], stages[k][3],
                          tgt_boxes, tgt_valid, cfg, alpha=cfg.focal_alpha)
            for k in idxs])
        out.append((costs.reshape(-1, *costs.shape[2:]),
                    tgt_valid.repeat(len(idxs), 1)))
    return out


def match(costs: list, matcher: str = 'hungarian') -> list:
    """``matcher_costs``' pairs -> each group's assignment (S*B, T)."""
    return [MATCHERS[matcher](c, v) for c, v in costs]


def ddetr_loss(outputs: Dict, targets: Dict, cfg: DDETRConfig,
               source: str, matcher: str = 'hungarian',
               num_boxes: Optional[torch.Tensor] = None,
               assign: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Every stage's losses and their weighted total ``loss``.

    ``outputs``: ``DDETRTransformer.forward``'s; ``targets``:
    {'class_labels', 'boxes', 'valid'}; ``source`` 'coco' | 'sa1b' picks
    the objectness head supervised (batches are single-source);
    ``matcher`` 'hungarian' (exact, on the host) or 'auction' (on the
    device); ``num_boxes`` the normalizing target count (default: this
    batch's); ``assign``: ``match``'s result on ``matcher_costs`` of these
    outputs, computed here when None."""
    tgt_labels = targets['class_labels']
    tgt_boxes = targets['boxes'].to(torch.float32)
    tgt_valid = targets['valid'].to(torch.bool)
    if num_boxes is None:
        num_boxes = tgt_valid.sum().to(torch.float32)
    num_boxes = num_boxes.clamp(min=1.0)

    stages = _stages(outputs, tgt_labels, cfg, source)
    if assign is None:
        assign = match(matcher_costs(outputs, targets, cfg, source),
                       matcher)
    b, t = tgt_valid.shape
    per_stage = [None] * len(stages)
    for idxs, a in zip(_groups(stages), assign):
        a = a.reshape(len(idxs), b, t)
        for j, k in enumerate(idxs):
            per_stage[k] = a[j]

    loss_dict = {}
    for k, (suffix, lg, bx, lab) in enumerate(stages):
        part = _single_stage_loss(lg, bx, lab, tgt_boxes, tgt_valid,
                                  num_boxes, cfg, matcher,
                                  assign=per_stage[k])
        loss_dict.update({f'{kk}{suffix}': v for kk, v in part.items()})

    weights = {'loss_ce': cfg.cls_loss_coefficient,
               'loss_bbox': cfg.bbox_loss_coefficient,
               'loss_giou': cfg.giou_loss_coefficient}
    total = torch.zeros((), dtype=torch.float32, device=tgt_boxes.device)
    for k, v in loss_dict.items():
        base = '_'.join(k.split('_enc')[0].split('_')[:2])
        if base in weights:
            total = total + weights[base] * v
    loss_dict['loss'] = total
    return loss_dict
