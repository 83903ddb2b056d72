"""Box geometry (counterpart of ``groma_tpu/ops/bbox.py``); pairwise ops
broadcast to (..., N, M)."""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _box_inter_union(boxes1, boxes2):
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    inter, union = _box_inter_union(boxes1, boxes2)
    return inter / union.clamp(min=1e-12)


def _giou(inter, union, lt, rb):
    iou = inter / union.clamp(min=1e-12)
    wh = (rb - lt).clamp(min=0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing.clamp(min=1e-12)


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)
    (HF ``generalized_box_iou``)."""
    inter, union = _box_inter_union(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    return _giou(inter, union, lt, rb)


def _elementwise_inter_union(boxes1, boxes2):
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter, union


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned xyxy boxes, (..., N, 4) x (..., N, 4) -> (..., N):
    the diagonal of ``generalized_box_iou``, element for element the same
    arithmetic."""
    inter, union = _elementwise_inter_union(boxes1, boxes2)
    return _giou(inter, union, torch.minimum(boxes1[..., :2], boxes2[..., :2]),
                 torch.maximum(boxes1[..., 2:], boxes2[..., 2:]))


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned xyxy boxes: (..., N, 4) x (..., N, 4) -> (..., N)."""
    inter, union = _elementwise_inter_union(boxes1, boxes2)
    return inter / union.clamp(min=1e-12)


def normalize_box_coordinates(boxes: torch.Tensor, img_shape) -> torch.Tensor:
    """xyxy pixel boxes -> normalized cxcywh clipped to [0, 1]."""
    h, w = img_shape[0], img_shape[1]
    scale = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return xyxy_to_cxcywh(boxes / scale).clamp(0.0, 1.0)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Logit with HF DeformableDetr clamping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
