"""Shared dataset machinery: the intro round, the <sep> masking idiom, and
fixed-shape finalization.

Every Groma training sample follows the same recipe (reference:
groma/data/datasets/refcoco_rec.py:153-202 and identical blocks in
flickr/visual_genome/llava/groma/coco datasets):

1. an intro round introducing the image + region streams,
2. task rounds whose answers are wrapped in ``<sep> ... <sep>``,
3. tokenize, mask labels outside the sep-pairs, re-label trailing EOS
   tokens, then delete the sep tokens,
4. attach normalized-cxcywh ground/refer boxes.

Step 5 here is TPU-specific: expand the result into the fixed device
layout (data/tokenization.py) and pad box lists to capacity.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from groma_tpu_torch.constants import DEFAULT_TOKENS, IGNORE_INDEX
from groma_tpu_torch.data.conversation import Conversation, conv_templates
from groma_tpu_torch.data.tokenization import expand_template
from groma_tpu_torch.data.tokenizer import BaseTokenizer

INTRO_INSTRUCT = ("Here is an image with region crops from it. "
                  "Image: {}. ".format(DEFAULT_TOKENS['image'])
                  + "Regions: {}.".format(DEFAULT_TOKENS['region']))
INTRO_ANSWER = 'Thank you for the image! How can I assist you with it?'


@dataclass(frozen=True)
class VLDataSpec:
    """Fixed capacities of the device batch layout."""
    num_image_tokens: int = 256
    max_region_num: int = 100
    max_seq_len: int = 2048
    max_ground_boxes: int = 48
    max_refer_boxes: int = 16
    image_size: int = 448


def intro_conversation(conv: Conversation) -> list:
    return [(conv.roles[0], INTRO_INSTRUCT), (conv.roles[1], INTRO_ANSWER)]


def tokenize_and_mask(prompt: str, tokenizer: BaseTokenizer):
    """The universal ``<sep>`` masking idiom
    (reference: groma/data/datasets/refcoco_rec.py:181-202)."""
    sp = tokenizer.sp
    ids = tokenizer.encode(prompt)
    labels = ids.copy()
    sep_inds = np.nonzero(ids == sp.sep)[0]
    assert len(sep_inds) % 2 == 0, 'unbalanced <sep> pairs'
    for i in range(0, len(sep_inds), 2):
        pre = 0 if i == 0 else sep_inds[i - 1]
        labels[pre:sep_inds[i]] = IGNORE_INDEX
    eos_inds = np.nonzero(ids == sp.eos)[0]
    labels[eos_inds[1:]] = sp.eos
    keep = ids != sp.sep
    return ids[keep], labels[keep]


def pad_boxes(boxes: Optional[np.ndarray], capacity: int):
    """(N, 4) -> ((capacity, 4), (capacity,) bool), truncating overflow."""
    out = np.zeros((capacity, 4), np.float32)
    valid = np.zeros((capacity,), bool)
    if boxes is not None and len(boxes):
        n = min(len(boxes), capacity)
        out[:n] = boxes[:n]
        valid[:n] = True
    return out, valid


def finalize_vl(input_ids: np.ndarray, labels: np.ndarray,
                image: np.ndarray, tokenizer: BaseTokenizer,
                spec: VLDataSpec, source: str,
                ground_boxes: Optional[np.ndarray] = None,
                refer_boxes: Optional[np.ndarray] = None) -> dict:
    """Raw sample -> fixed-shape device sample."""
    sp = tokenizer.sp
    t = expand_template(input_ids, labels, sp, spec.num_image_tokens,
                        spec.max_region_num, spec.max_seq_len)
    gb, gv = pad_boxes(ground_boxes, spec.max_ground_boxes)
    rb, rv = pad_boxes(refer_boxes, spec.max_refer_boxes)
    return {
        'input_ids': t['input_ids'], 'labels': t['labels'],
        'region_slot': t['region_slot'], 'valid': t['valid'],
        'images': image.astype(np.float32),
        'ground_boxes': gb, 'ground_valid': gv,
        'refer_boxes': rb, 'refer_valid': rv,
        'source': source,
    }


class ConversationDatasetMixin:
    """Common construction for conversation-style datasets."""

    def _setup(self, tokenizer: BaseTokenizer, conv_temp: str,
               spec: VLDataSpec, seed: int = 0):
        self.tokenizer = tokenizer
        self.conv_temp = conv_templates[conv_temp]
        self.spec = spec
        self.seed = seed

    def sample_rngs(self, idx: int):
        """Per-sample deterministic RNGs — safe under the threaded loader
        (a shared numpy Generator is not thread-safe) and independent of
        access order (multi-host determinism)."""
        rng = np.random.default_rng((self.seed, idx))
        pyrng = random.Random((self.seed << 32) | idx)
        return rng, pyrng

    def build_sample(self, task_rounds: Sequence[Tuple[str, str]],
                     image: np.ndarray, source: str,
                     ground_boxes=None, refer_boxes=None) -> dict:
        conv = self.conv_temp
        messages = intro_conversation(conv)
        messages.extend(task_rounds)
        prompt = conv.get_prompt(messages)
        ids, labels = tokenize_and_mask(prompt, self.tokenizer)
        return finalize_vl(ids, labels, image, self.tokenizer, self.spec,
                           source, ground_boxes, refer_boxes)
