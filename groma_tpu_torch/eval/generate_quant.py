"""Quantized-LLM Groma generation: vision in the model's dtypes, weight-only
int8 or int4 LLaMA (or the bf16 ``bits=16`` tree), optional int8 KV cache
(counterpart of ``groma_tpu/eval/generate_quant.py``; greedy only, no
speculative decoding).

``generate`` has the JAX generator's signature and return values: greedy
tokens as a numpy (B, W) array, each row cut after its first EOS and
padded with EOS, plus the selected boxes and mask as numpy arrays.  Decode
stops once every row has emitted EOS, and never runs a forward whose
logits would go unused, so it runs ``decode_forwards`` <= max_new_tokens - 1
forwards; the tokens are those of the JAX scan.  A request whose decode
would not fit the cache raises ValueError (the JAX cache write clamps).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from groma_tpu_torch.config import GromaConfig
from groma_tpu_torch.eval.generate import parse_region_tokens  # noqa: F401
from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama import make_kv_cache
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_forward,
                                                quant_llama_logits,
                                                quantize_llama_params)


def quantize_groma_llm(model: GromaModel, cfg: GromaConfig,
                       bits: int = 8) -> dict:
    """The LLM branch of a GromaModel -> the quantized tree (``bits`` 8, 4
    or 16, see ``quantize_llama_params``); embeddings and the small extra
    head are kept in bf16."""
    qp = quantize_llama_params(model.llm.state_dict(), cfg.llm, bits=bits)
    qp['new_input_embs'] = model.new_input_embs.weight.to(torch.bfloat16)
    qp['extra_lm_head'] = model.extra_lm_head.weight.T.to(torch.bfloat16)
    return qp


def quant_logits(qp: dict, hidden) -> torch.Tensor:
    """Dual-head logits in f32: the quantized base head, then the bf16
    extra head for the new tokens (f32 products)."""
    base = quant_llama_logits(qp, hidden)
    extra = hidden.to(torch.bfloat16).to(torch.float32) @ \
        qp['extra_lm_head'].to(torch.float32)
    return torch.cat([base.to(torch.float32), extra], dim=-1)


def quant_embed(qp: dict, ids, base_vocab: int) -> torch.Tensor:
    """Split-vocabulary embedding lookup from the tree's bf16 tables."""
    is_new = ids >= base_vocab
    e = qp['embed_tokens'][torch.where(is_new, 0, ids)]
    n = qp['new_input_embs'][torch.where(is_new, ids - base_vocab, 0)]
    return torch.where(is_new[..., None], n, e)


class QuantGenerator:
    """Prefill + greedy decode with the quantized LLM.  ``kv_bits=8`` keeps the
    KV cache in int8 with per-token scales (the served configuration).

    After each ``generate`` call, ``last_stats`` holds what a caller may
    want to check or report: decode_forwards, prefill_ms,
    decode_ms_per_token (host clock around synchronized device work),
    logits_finite, and the tokens, selected_boxes and selected_mask."""

    def __init__(self, model: GromaModel, qp: dict, max_len: int = 2048,
                 kv_bits: int = 16):
        if kv_bits not in (8, 16):
            raise ValueError('kv_bits must be 8 or 16')
        self.model = model
        self.cfg = model.cfg
        self.qp = qp
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.device = qp['norm'].device
        self.last_stats = None

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.array(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def generate(self, images, input_ids, region_slot, base_valid,
                 refer_boxes=None, refer_valid=None,
                 max_new_tokens: int = 32, eos_id: int = 2):
        cfg = self.cfg
        images = self._tensor(images, torch.float32)
        input_ids = self._tensor(input_ids, torch.int64)
        region_slot = self._tensor(region_slot, torch.int64)
        base_valid = self._tensor(base_valid, torch.bool)
        b, s = input_ids.shape
        if s + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f'max_new_tokens={max_new_tokens} does not fit the KV cache: '
                f'the {s}-token stream leaves {self.max_len - s} of '
                f'{self.max_len} slots for decode')
        if refer_boxes is not None:
            refer_boxes = self._tensor(refer_boxes, torch.float32)
            refer_valid = self._tensor(refer_valid, torch.bool)

        self._sync()
        t0 = time.perf_counter()
        emb, _, valid, vis = self.model.prepare_stream(
            images, input_ids, region_slot, base_valid,
            refer_boxes=refer_boxes, refer_valid=refer_valid)
        pos = (torch.cumsum(valid.to(torch.int64), -1) - 1).clamp(min=0)
        if self.kv_bits == 8:
            cache = make_quant_kv_cache(cfg.llm, b, self.max_len,
                                        device=self.device)
        else:
            cache = make_kv_cache(cfg.llm, b, self.max_len,
                                  device=self.device)
        hidden, cache = quant_llama_forward(self.qp, cfg.llm, emb, valid,
                                            pos, cache)
        rows = torch.arange(b, device=self.device)
        last = torch.argmax(pos, dim=-1)
        logits = quant_logits(self.qp, hidden[rows, last][:, None])[:, 0]
        next_pos = pos[rows, last][:, None] + 1
        self._sync()
        t1 = time.perf_counter()

        finite = torch.isfinite(logits).all()
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        ones = torch.ones((b, 1), dtype=torch.bool, device=self.device)
        toks = []
        forwards = 0
        for i in range(max_new_tokens):
            tok = torch.where(done, eos_id, torch.argmax(logits, dim=-1))
            done = done | (tok == eos_id)
            toks.append(tok)
            if i == max_new_tokens - 1 or bool(done.all()):
                break
            hidden, cache = quant_llama_forward(
                self.qp, cfg.llm,
                quant_embed(self.qp, tok[:, None], cfg.llm.vocab_size),
                ones, next_pos + i, cache)
            logits = quant_logits(self.qp, hidden)[:, -1]
            finite = finite & torch.isfinite(logits).all()
            forwards += 1
        toks = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
        self._sync()
        t2 = time.perf_counter()

        out = []
        for row in toks:
            stop = np.nonzero(row == eos_id)[0]
            out.append(row[:stop[0] + 1] if len(stop) else row)
        width = max(len(r) for r in out)
        tokens = np.full((b, width), eos_id, toks.dtype)
        for i, r in enumerate(out):
            tokens[i, :len(r)] = r
        vis_np = {'selected_boxes': vis['selected_boxes'].float().cpu().numpy(),
                  'selected_mask': vis['selected_mask'].cpu().numpy()}
        self.last_stats = {
            'decode_forwards': forwards,
            'prefill_ms': (t1 - t0) * 1e3,
            'decode_ms_per_token': (t2 - t1) * 1e3 / max(forwards, 1),
            'logits_finite': bool(finite),
            'tokens': tokens, **vis_np}
        return tokens, vis_np
