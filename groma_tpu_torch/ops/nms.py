"""Static-shape class-agnostic greedy NMS (counterpart of
``groma_tpu/ops/nms.py``), batched over a leading dimension.

Semantics, as in the JAX package (mmcv's): only ``score > score_threshold``
survives the pre-filter; a stable descending sort breaks score ties by
input index; a kept box suppresses later boxes with IoU strictly greater
than ``iou_threshold``; survivors come back in descending-score order in a
fixed ``max_num`` buffer plus a validity mask.  The loop stays on the
device (no host read inside it).
"""

from __future__ import annotations

import torch

from groma_tpu_torch.ops.bbox import box_iou

NEG_INF = -1e30


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        score_threshold: float = 0.0, max_num: int = 100,
        valid: torch.Tensor | None = None):
    """boxes (..., N, 4) xyxy, scores (..., N), valid (..., N) bool ->
    keep_idx (..., max_num) int32 (descending score, 0 where unused) and
    keep_mask (..., max_num) bool."""
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n).to(torch.float32)
    alive = scores > score_threshold
    if valid is not None:
        alive = alive & valid.reshape(-1, n)
    masked = torch.where(alive, scores, NEG_INF)
    order = torch.argsort(-masked, dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sorted_alive = torch.gather(alive, 1, order)

    later = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    overlaps = (box_iou(sorted_boxes, sorted_boxes) > iou_threshold) & later
    keep = torch.zeros_like(sorted_alive)
    suppressed = torch.zeros_like(sorted_alive)
    for i in range(n):
        keep_i = sorted_alive[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & overlaps[:, i]

    # compact kept positions to the front, keeping descending-score order
    front = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    num_kept = keep.sum(-1, keepdim=True)
    keep_idx = torch.gather(order, 1, front).to(torch.int32)
    if n >= max_num:
        keep_idx = keep_idx[:, :max_num]
    else:
        keep_idx = torch.nn.functional.pad(keep_idx, (0, max_num - n))
    rank = torch.arange(max_num, device=boxes.device)[None]
    keep_mask = rank < num_kept.clamp(max=max_num)
    keep_idx = torch.where(keep_mask, keep_idx, 0)
    return (keep_idx.reshape(*lead, max_num),
            keep_mask.reshape(*lead, max_num))
