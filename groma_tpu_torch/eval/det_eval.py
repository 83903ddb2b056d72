"""Detector-stage evaluation (counterpart of ``groma_tpu/eval/det_eval.py``;
reference: groma/train/train_det.py:97-158 post_process and its eval
loop).

``post_process`` as the reference's: sigmoid over the coco logits, one
top-k over (query, class), cxcywh -> xyxy, rescaled to the original image
size.  Scores go through the numpy COCO-protocol evaluator
(``eval/coco_map.py``).  The forward runs as a captured CUDA graph on the
card, the counterpart of JAX's ``jax.jit`` of it: one graph per image
shape, kept with the perceiver across evaluations, as ``jax.jit`` keeps
its compiled forward.
"""

from __future__ import annotations

import weakref
from typing import Iterable

import numpy as np
import torch

from groma_tpu_torch.eval.coco_map import DetectionEvaluator
from groma_tpu_torch.ops.bbox import cxcywh_to_xyxy
from groma_tpu_torch.utils.graphs import CallGraph

# image shapes whose graphs a perceiver keeps, the least recent dropped
EVAL_SHAPES = 4
# perceiver -> its evaluation forward's graphs
_GRAPHS = weakref.WeakKeyDictionary()


def collate_det_eval(samples):
    """(reference: groma/data/collator.py:55-62
    DataCollatorForDetEvalDataset)."""
    return {
        'images': np.stack([s['images'] for s in samples]),
        'ori_shapes': np.stack([np.asarray(s['ori_shape'][:2])
                                for s in samples]),
    }


def post_process(logits_coco: torch.Tensor, pred_boxes: torch.Tensor,
                 target_sizes: torch.Tensor, threshold: float = 0.0,
                 top_k: int = 100):
    """(B, Q, C) logits + (B, Q, 4) cxcywh + (B, 2) (h, w) -> per image
    (scores, labels, boxes_xyxy_abs, keep), top_k each."""
    b, q, c = logits_coco.shape
    prob = torch.sigmoid(logits_coco).reshape(b, q * c)
    values, indexes = torch.topk(prob, min(top_k, q * c), dim=1)
    labels = indexes % c
    boxes = cxcywh_to_xyxy(pred_boxes).gather(
        1, (indexes // c)[..., None].expand(-1, -1, 4))
    sizes = target_sizes.to(torch.float32)
    img_h, img_w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, :]
    return values, labels, boxes * scale, values > threshold


def detector_forward(perceiver, images: torch.Tensor) -> dict:
    """The evaluation's forward: the coco head's logits and the boxes."""
    out = perceiver(images)
    return {'logits': out['logits']['coco'], 'boxes': out['pred_boxes']}


def forward_graph(perceiver) -> CallGraph:
    """The graphs of ``perceiver``'s evaluation forward: made at its first
    evaluation and kept while it lives, one per image shape (the
    EVAL_SHAPES most recent).  A replay reads the parameters where they
    lie: updated in place, they are read anew; moved, the graphs are
    stale."""
    if perceiver not in _GRAPHS:
        _GRAPHS[perceiver] = CallGraph(keep=EVAL_SHAPES)
    return _GRAPHS[perceiver]


@torch.no_grad()
def evaluate_detector(perceiver, samples: Iterable[dict], top_k: int = 100,
                      threshold: float = 0.0) -> dict:
    """samples: dicts with 'images' (H, W, 3 normalized), 'image_id',
    'ori_shape' (h, w), 'gt' a list of (category_id, xyxy absolute box).
    Runs on the perceiver's device; on the card the forward is a CUDA
    graph per image shape (``forward_graph``, JAX's jitted forward), the
    first evaluation at a shape paying its warm-up and capture;
    ``post_process`` runs after it."""
    dev = next(perceiver.parameters()).device
    graph = forward_graph(perceiver)
    ev = DetectionEvaluator(max_dets=top_k)
    for s in samples:
        for cat, box in s.get('gt', []):
            ev.add_ground_truth(s['image_id'], cat, box)
        out = graph.run(lambda _, x: detector_forward(perceiver, x), None,
                        torch.as_tensor(np.asarray(s['images'])[None],
                                        dtype=torch.float32, device=dev),
                        key=(perceiver.training,))
        sizes = torch.as_tensor(np.asarray(s['ori_shape'][:2])[None],
                                device=dev)
        scores, labels, boxes, keep = (t[0].cpu().numpy() for t in
                                       post_process(out['logits'],
                                                    out['boxes'], sizes,
                                                    threshold, top_k))
        for sc, lb, bx, kp in zip(scores, labels, boxes, keep):
            if kp:
                ev.add_detection(s['image_id'], int(lb), bx, float(sc))
    return ev.summarize()
