"""Special-token ids + fixed-layout token-stream templates.

The reference rewrites every sequence on-device per step: `<image>` expands
to 256 copies, `<region>` expands to n pairs ``[<rK>, <region>]`` where n is
the NMS survivor count, then the batch is re-padded
(reference: groma/model/groma.py:317-357).  That dynamic-shape surgery is
the single biggest XLA impedance mismatch in the reference.

TPU-first replacement: the *host-side* collator pre-expands each sequence
into a fixed ``max_seq_len`` layout with

* ``num_image_tokens`` fixed ``<image>`` slots,
* a fixed block of ``max_region_num`` pairs ``[<rk>, <region>]`` — region
  indices are always sequential because the reference randomizes the *box
  order*, not the index order (groma.py:273-279,330-332),
* ``region_slot[p]`` = region index for positions inside the region block
  (-1 elsewhere), so the device can mask unused region slots with the NMS
  validity mask at runtime,
* pad slots anywhere; the LLM uses mask-cumsum position ids, which makes
  the padded stream numerically identical to the reference's compacted one
  (verified in tests/test_llama.py).

Token id assignment matches the reference's ``tokenizer.add_tokens`` order
(reference: groma/train/train.py:83-91): base vocab, then the 14 newly
added named special tokens, then ``<r0>..<r99>`` (114 total).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from groma_tpu_torch.constants import (DEFAULT_TOKENS, EXISTING_IN_BASE,
                                 IGNORE_INDEX, NEW_TOKENS,
                                 NUM_REGION_TOKENS)


@dataclass(frozen=True)
class SpecialIds:
    """Ids of the protocol tokens in the extended vocabulary.

    bos/eos/unk live in the base vocab (LLaMA ids 1/2/0) and are NOT
    re-added (reference: groma/train/train.py:90 add_tokens skips existing
    tokens, so num_new_token == 114 for Vicuna)."""
    base_vocab: int
    pad: int
    sep: int
    image: int
    region: int
    rbox: int
    gbox: int
    rfeat: int
    box_idx_start: int   # <r0>; <rK> = box_idx_start + K
    bos: int = 1
    eos: int = 2
    unk: int = 0

    @classmethod
    def from_base_vocab(cls, base_vocab: int) -> 'SpecialIds':
        names = [n for n in DEFAULT_TOKENS if n not in EXISTING_IN_BASE]
        off = {n: base_vocab + i for i, n in enumerate(names)}
        return cls(
            base_vocab=base_vocab,
            pad=off['pad'],
            sep=off['sep'],
            image=off['image'],
            region=off['region'],
            rbox=off['rbox'],
            gbox=off['gbox'],
            rfeat=off['rfeat'],
            box_idx_start=base_vocab + len(names),
        )

    @property
    def num_new_token(self) -> int:
        return len(NEW_TOKENS)

    def box_idx_ids(self) -> np.ndarray:
        return np.arange(self.box_idx_start,
                         self.box_idx_start + NUM_REGION_TOKENS)


def expand_template(input_ids: np.ndarray,
                    labels: np.ndarray | None,
                    sp: SpecialIds,
                    num_image_tokens: int,
                    max_region_num: int,
                    max_seq_len: int):
    """Host-side expansion of one raw sequence into the fixed device layout.

    Mirrors the reference's placeholder injection
    (reference: groma/model/groma.py:317-357) with fixed capacities.

    Args:
      input_ids: (S,) raw ids containing one ``<image>`` and one ``<region>``
        placeholder (their ids from ``sp``).
      labels: optional (S,) with IGNORE_INDEX on unsupervised positions.

    Returns dict with fixed-shape arrays:
      input_ids (L,), labels (L,), region_slot (L,) int32, valid (L,) bool.
    """
    assert (input_ids == sp.image).sum() == 1, 'expect one <image>'
    assert (input_ids == sp.region).sum() == 1, 'expect one <region>'
    img_pos = int(np.nonzero(input_ids == sp.image)[0][0])
    reg_pos = int(np.nonzero(input_ids == sp.region)[0][0])
    assert img_pos < reg_pos, 'image block must precede region block ' \
        '(reference: groma/model/groma.py:328)'

    img_block = np.full(num_image_tokens, sp.image, dtype=np.int64)
    reg_block = np.empty(2 * max_region_num, dtype=np.int64)
    reg_block[0::2] = sp.box_idx_start + np.arange(max_region_num)
    reg_block[1::2] = sp.region

    pieces = [input_ids[:img_pos], img_block,
              input_ids[img_pos + 1:reg_pos], reg_block,
              input_ids[reg_pos + 1:]]
    out_ids = np.concatenate(pieces)

    slot = np.full(len(out_ids), -1, dtype=np.int32)
    reg_start = img_pos + num_image_tokens + (reg_pos - img_pos - 1)
    slot[reg_start:reg_start + 2 * max_region_num] = \
        np.repeat(np.arange(max_region_num, dtype=np.int32), 2)

    if labels is not None:
        lab = np.concatenate([
            labels[:img_pos],
            np.full(num_image_tokens, IGNORE_INDEX, dtype=np.int64),
            labels[img_pos + 1:reg_pos],
            np.full(2 * max_region_num, IGNORE_INDEX, dtype=np.int64),
            labels[reg_pos + 1:]])
    else:
        lab = np.full(len(out_ids), IGNORE_INDEX, dtype=np.int64)

    valid = out_ids != sp.pad
    n = len(out_ids)
    if n > max_seq_len:
        out_ids = out_ids[:max_seq_len]
        lab = lab[:max_seq_len]
        slot = slot[:max_seq_len]
        valid = valid[:max_seq_len]
    elif n < max_seq_len:
        padn = max_seq_len - n
        out_ids = np.concatenate([out_ids,
                                  np.full(padn, sp.pad, dtype=np.int64)])
        lab = np.concatenate([lab,
                              np.full(padn, IGNORE_INDEX, dtype=np.int64)])
        slot = np.concatenate([slot, np.full(padn, -1, dtype=np.int32)])
        valid = np.concatenate([valid, np.zeros(padn, dtype=bool)])
    return {'input_ids': out_ids, 'labels': lab, 'region_slot': slot,
            'valid': valid}
