"""REC (referring expression comprehension) evaluation harness (counterpart
of ``groma_tpu/eval/rec.py``): greedy-generate up to 3 tokens, parse the
first ``<rK>`` index, take box K of the prefill's selected proposal pool,
and score its IoU against the ground truth: acc@0.5, mIoU and miss rate.

Across processes the counts are summed by a ``torch.distributed``
all-reduce when a process group is initialised (the reference's
``torch.distributed.reduce``), and left alone otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from groma_tpu_torch.constants import DEFAULT_TOKENS
from groma_tpu_torch.data.conversation import conv_templates
from groma_tpu_torch.data.datasets.base import VLDataSpec, intro_conversation
from groma_tpu_torch.data.tokenization import expand_template
from groma_tpu_torch.eval.generate import parse_region_tokens

T = DEFAULT_TOKENS

# the eval-time REC prompt
REC_EVAL_INSTRUCTION = 'Locate {} in the image.'


def build_rec_prompt(expr: str, tokenizer, spec: VLDataSpec,
                     conv_temp: str = 'llava'):
    """The prompt up to the open assistant turn, expanded to the model's
    fixed stream layout."""
    conv = conv_templates[conv_temp]
    messages = intro_conversation(conv)
    refexp = T['boe'] + expr.strip() + T['eoe']
    messages.append((conv.roles[0], REC_EVAL_INSTRUCTION.format(refexp)))
    messages.append((conv.roles[1], None))
    ids = tokenizer.encode(conv.get_prompt(messages))
    return expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                           spec.max_region_num, spec.max_seq_len)


def _iou_xyxy(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def _cxcywh_to_xyxy(b):
    return np.array([b[0] - b[2] / 2, b[1] - b[3] / 2,
                     b[0] + b[2] / 2, b[1] + b[3] / 2])


@dataclass
class RECMetrics:
    """Accumulates acc@0.5, mIoU and the miss rate."""
    correct: float = 0.0
    iou_sum: float = 0.0
    missed: float = 0.0
    total: float = 0.0

    def update(self, pred_box_cxcywh: Optional[np.ndarray],
               gt_box_cxcywh: np.ndarray):
        self.total += 1
        if pred_box_cxcywh is None:
            self.missed += 1
            return
        iou = _iou_xyxy(_cxcywh_to_xyxy(pred_box_cxcywh),
                        _cxcywh_to_xyxy(gt_box_cxcywh))
        self.iou_sum += iou
        if iou > 0.5:
            self.correct += 1

    def merge(self, other: 'RECMetrics'):
        self.correct += other.correct
        self.iou_sum += other.iou_sum
        self.missed += other.missed
        self.total += other.total

    def psum_across_hosts(self):
        """Sum the counts over the processes of the default process group
        (an all-reduce, on the card under NCCL); a no-op without one."""
        import torch
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self
        device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
        vals = torch.tensor([self.correct, self.iou_sum, self.missed,
                             self.total], dtype=torch.float64, device=device)
        dist.all_reduce(vals)
        self.correct, self.iou_sum, self.missed, self.total = vals.tolist()
        return self

    def summary(self) -> dict:
        """Python numbers (JSON-ready): once a box is predicted the IoU
        sum is a numpy f32, which ``json.dumps`` refuses (JAX's summary
        returns it as is)."""
        t = max(self.total, 1)
        return {
            'acc@0.5': float(self.correct / t),
            'miou': float(self.iou_sum / t),
            'miss_rate': float(self.missed / t),
            'total': int(self.total),
        }


def evaluate_rec(generator, samples: Iterable[dict], tokenizer,
                 spec: VLDataSpec, max_new_tokens: int = 3,
                 batch_size: int = 1) -> dict:
    """``samples``: dicts with 'image' (H, W, 3 normalized), 'expr' and
    'gt_box' (normalized cxcywh).  ``batch_size`` prompts go through the
    generator at once; a ragged last batch is padded with copies of its
    last sample, which are not scored."""
    sp = tokenizer.sp
    metrics = RECMetrics()

    def flush(group, real_n):
        ts = [build_rec_prompt(s['expr'], tokenizer, spec) for s in group]
        tokens, vis = generator.generate(
            np.stack([s['image'] for s in group]),
            np.stack([t['input_ids'] for t in ts]),
            np.stack([t['region_slot'] for t in ts]),
            np.stack([t['valid'] for t in ts]),
            max_new_tokens=max_new_tokens, eos_id=sp.eos)
        all_ks = parse_region_tokens(tokens, sp.box_idx_start)
        cap = vis['selected_mask'].shape[1]
        for i in range(real_n):
            ks = all_ks[i]
            pred = None
            if ks and ks[0] < cap and vis['selected_mask'][i, ks[0]]:
                pred = vis['selected_boxes'][i, ks[0]]
            metrics.update(pred, np.asarray(group[i]['gt_box']))

    group = []
    for s in samples:
        group.append(s)
        if len(group) == batch_size:
            flush(group, batch_size)
            group = []
    if group:
        real_n = len(group)
        flush(group + [group[-1]] * (batch_size - real_n), real_n)
    metrics.psum_across_hosts()
    return metrics.summary()
