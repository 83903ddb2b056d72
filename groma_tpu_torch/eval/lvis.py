"""LVIS-Ground evaluation harness (counterpart of ``groma_tpu/eval/lvis.py``;
reference: groma/eval/eval_lvis.py).

Per category a grounding prompt ("Locate all <category> in this image."),
at most 10 greedy tokens through the port's ``Generator``, each emitted
``<rK>`` mapped back to proposal box K, scored as COCO-format detections
(earlier mentions higher), AP/AR with the LVIS rare / common / frequent
buckets (``eval/coco_map.py``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from groma_tpu_torch.constants import DEFAULT_TOKENS
from groma_tpu_torch.data.conversation import conv_templates
from groma_tpu_torch.data.datasets.base import VLDataSpec, intro_conversation
from groma_tpu_torch.data.tokenization import expand_template
from groma_tpu_torch.eval.coco_map import DetectionEvaluator
from groma_tpu_torch.eval.generate import Generator, parse_region_tokens

T = DEFAULT_TOKENS
LVIS_INSTRUCTION = 'Locate all {} in this image.'


def build_ground_prompt(category: str, tokenizer, spec: VLDataSpec,
                        conv_temp: str = 'llava'):
    conv = conv_templates[conv_temp]
    messages = intro_conversation(conv)
    refexp = T['boe'] + category + T['eoe']
    messages.append((conv.roles[0], LVIS_INSTRUCTION.format(refexp)))
    messages.append((conv.roles[1], None))
    ids = tokenizer.encode(conv.get_prompt(messages))
    return expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                           spec.max_region_num, spec.max_seq_len)


def evaluate_lvis(generator: Generator, samples: Iterable[dict],
                  tokenizer, spec: VLDataSpec, cat_frequencies=None,
                  max_new_tokens: int = 10) -> dict:
    """samples: dicts with image (H, W, 3 normalized), image_id,
    category_id, category_name, gt_boxes (N, 4) normalized cxcywh."""
    sp = tokenizer.sp
    ev = DetectionEvaluator(cat_frequencies=cat_frequencies)
    for s in samples:
        for b in np.asarray(s['gt_boxes']).reshape(-1, 4):
            ev.add_ground_truth(s['image_id'], s['category_id'],
                                _cxcywh_to_xyxy(b))
        t = build_ground_prompt(s['category_name'], tokenizer, spec)
        tokens, vis = generator.generate(
            s['image'][None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None], max_new_tokens=max_new_tokens, eos_id=sp.eos)
        ks = parse_region_tokens(tokens, sp.box_idx_start)[0]
        cap = vis['selected_mask'].shape[1]
        for rank, k in enumerate(ks):
            if k >= cap or not vis['selected_mask'][0, k]:
                continue
            box = _cxcywh_to_xyxy(vis['selected_boxes'][0, k])
            # earlier mentions score higher (the reference keeps emit order)
            ev.add_detection(s['image_id'], s['category_id'], box,
                             score=1.0 - 0.01 * rank)
    return ev.summarize()


def _cxcywh_to_xyxy(b):
    return np.array([b[0] - b[2] / 2, b[1] - b[3] / 2,
                     b[0] + b[2] / 2, b[1] + b[3] / 2])
