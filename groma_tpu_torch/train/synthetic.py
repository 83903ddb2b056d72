"""A synthetic grounded VL batch in the training layout, made from a seed,
for driving the trainer on random weights without a dataset.

Each row's raw ids (bos, a system prompt, ``<image>``, ``<region>``, a
question, an answer with three ``<ground_box>`` tokens, eos) go through the
host-side ``expand_template`` and ``collate_vl`` that the trainer's data
pipeline uses, so the stream carries the image block, the region slots and
a padded tail as a real batch does.  Ground boxes are random cxcywh.
"""

from __future__ import annotations

import numpy as np

from groma_tpu_torch.config import GromaConfig
from groma_tpu_torch.constants import IGNORE_INDEX
from groma_tpu_torch.data.build import collate_vl
from groma_tpu_torch.data.tokenization import SpecialIds, expand_template


def grounded_batch(cfg: GromaConfig, batch_size: int, seed: int,
                   answer_lens=(1300, 700)) -> dict:
    """``batch_size`` rows; row i's answer has ``answer_lens[i % n]``
    tokens, supervised (with eos), the prompt is not."""
    rng = np.random.default_rng(seed)
    sp = SpecialIds.from_base_vocab(cfg.llm.vocab_size)
    size = cfg.perceiver.image_size
    samples = []
    for i in range(batch_size):
        def words(n):
            return rng.integers(3, cfg.llm.vocab_size, n)
        n_ans = answer_lens[i % len(answer_lens)]
        answer = words(n_ans)
        answer[[n_ans // 4, n_ans // 2, 3 * n_ans // 4]] = sp.gbox
        prompt = np.concatenate([[1], words(40), [sp.image], words(12),
                                 [sp.region], words(30)])
        raw = np.concatenate([prompt, answer, [2]])
        labels = np.concatenate([np.full(len(prompt), IGNORE_INDEX),
                                 answer, [2]])
        t = expand_template(raw, labels, sp, cfg.num_image_tokens,
                            cfg.max_region_num, cfg.max_seq_len)
        centre = rng.uniform(0.25, 0.75, (3, 2))
        wh = rng.uniform(0.1, 0.4, (3, 2))
        samples.append(dict(
            t, images=rng.standard_normal((size, size, 3)).astype(np.float32),
            ground_boxes=np.concatenate([centre, wh], -1).astype(np.float32),
            ground_valid=np.ones(3, bool),
            refer_boxes=np.zeros((1, 4), np.float32),
            refer_valid=np.zeros(1, bool)))
    return collate_vl(samples)


def grounded_kv_mask(batch: dict, kept) -> np.ndarray:
    """(B, S) key mask of the batch's streams once NMS has kept ``kept[i]``
    regions of row i: the padded tail, plus the unused region slots (gaps
    in mid-sequence)."""
    slot = batch['region_slot']
    kept = np.asarray(kept)[:len(slot), None]
    return batch['valid'] & ((slot < 0) | (slot < kept))
