"""The frozen operation and byte counters against hand counts, and the
valid rows they count."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline as rf
from portbench.traffic import layout

LLM = {'hidden_size': 512, 'intermediate_size': 1024,
       'num_hidden_layers': 2, 'num_attention_heads': 4,
       'num_key_value_heads': 4, 'vocab_size': 1000}


@pytest.mark.parametrize('k,n,rows', [(4096, 4096, 3), (11008, 4096, 8)])
def test_int4_matmul_by_hand(k, n, rows):
    nbytes, ops = rf.int4_matmul_work([(k, n)], rows)
    assert nbytes == k * n / 2 + (k // 256) * n * 4 + 2 * rows * (k + n)
    assert ops == 2 * rows * k * n


def test_decode_step_counts_weights_once_and_live_rows():
    w0, _ = rf.decode_step_int4_work(LLM, 0)
    # qkv 512x1536, o 512x512, gate|up 512x2048, down 1024x512; head
    # 512x1024 (1000 padded to 1024)
    shapes = [(512, 1536), (512, 512), (512, 2048), (1024, 512)] * 2 \
        + [(512, 1024)]
    assert w0 == sum(k * n / 2 + (k // 256) * n * 4 for k, n in shapes)
    w2, ops2 = rf.decode_step_int4_work(LLM, 2)
    assert w2 - w0 == 2 * 2 * sum(k + n for k, n in shapes)
    assert ops2 == 2 * 2 * sum(k * n for k, n in shapes)


@pytest.mark.parametrize('context', [1, 300])
def test_paged_attention_by_hand(context):
    nbytes, ops = rf.paged_attention_work(LLM, context)
    per_layer = 2 * context * 4 * (128 + 4) + 2 * 4 * 512
    assert nbytes == 2 * per_layer
    assert ops == 2 * (2 * 2 * context * 4 * 128)


def test_prefill_flops_by_hand():
    mm = 2 * (512 * 1536 + 512 * 512 + 512 * 2048 + 1024 * 512)
    tokens = 10
    attn = 2 * 2 * 512 * tokens * (tokens + 1) / 2
    head = 2 * 512 * (1000 + 114)
    assert rf.llm_prefill_flops(LLM, tokens, 114) == \
        2 * (tokens * mm + attn) + head


def test_valid_rows_only():
    """A prompt's valid tokens drop the region pairs that were not kept;
    the work of 5 valid tokens is not that of the 2048 packed slots."""
    from types import SimpleNamespace
    from portbench.drivers.engine import prompt_tokens
    ids, slot, valid = layout((np.arange(3, 8), np.arange(3, 5),
                               np.arange(3, 6)), 1000, 4, 8, 64)
    mask = np.zeros(8, bool)
    mask[:3] = True
    rec = SimpleNamespace(req=SimpleNamespace(region_slot=slot, valid=valid),
                          session=SimpleNamespace(vis={'selected_mask': mask}))
    assert valid.sum() == 5 + 4 + 2 + 16 + 3
    assert prompt_tokens(rec) == 5 + 4 + 2 + 2 * 3 + 3
    assert rf.prefill_int4_work(LLM, 5)[1] < rf.prefill_int4_work(LLM, 64)[1]
