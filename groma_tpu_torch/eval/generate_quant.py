"""Quantized-LLM Groma generation: vision in the model's dtypes, weight-only
int8 or int4 LLaMA (or the bf16 ``bits=16`` tree), optional int8 KV cache
(counterpart of ``groma_tpu/eval/generate_quant.py``; greedy only).

``use_flash`` takes the flash kernels in the vision tower (#3) and in the
LLM prefill from ``FLASH_MIN_SEQ`` tokens on (#4); ``w8a8_prefill`` runs
the prefill's layer matmuls as int8 x int8 products (int8 trees);
``spec_lookahead=G`` > 0 decodes a batch of one by prompt-lookup
speculative decoding (``eval/speculative.py``): one (1, G+1) verify
forward, a captured ``Verifier`` step, per accepted run, with the tokens
of sequential greedy decoding.

``generate`` has the JAX generator's signature and return values: greedy
tokens as a numpy (B, W) array, each row cut after its first EOS and
padded with EOS, plus the selected boxes and mask as numpy arrays.  The
decode is JAX's ``decode_scan`` body (greedy token, done mask, the token
written at a device step counter, one forward at a device cache index) as
a ``utils.graphs.StepGraph`` over a ``generate.DecodeScan``'s static
state, kept across calls of one batch size and EOS id: on the card the
first call runs one warm-up step and one capture, every further step is a
replay; on the CPU the same step runs eagerly.  JAX runs every step and
trims after EOS; here the host reads the done mask once every
``DONE_CHECK_STEPS`` steps and stops there once every row has emitted EOS,
so it runs ``decode_forwards`` <= max_new_tokens - 1 forwards, never one
whose logits would go unused at the end; the tokens are those of the JAX
scan.  A request whose decode would not fit the cache raises ValueError
(the JAX cache write clamps), with speculation counting every slot a last
verify could write.

On a tree cut for tensor parallelism (``quantize_groma_llm`` on a
tp-cut model, or ``parallel/mesh.cut_quant_tree``) every rank of the tp
group runs the generator with the same inputs; under a gloo group the
prefill, the scan and the verify run eagerly (``last_stats``'
``prefill_mode`` and ``decode_mode``).

The prefill (vision, surgery, the LLM prefill into the decode's cache or
the verifier's, the first logits: JAX's jitted prefill program) is one
``utils.graphs.CallGraph`` per (B, S): on the card the key's first call
warms up, captures and replays, every later one copies its inputs in and
replays; on the CPU it runs eagerly (``last_stats['prefill_mode']``,
'captured' or 'eager').  The cache's index after it is S, set on the
host after the replay.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from groma_tpu_torch.config import GromaConfig
from groma_tpu_torch.eval.generate import DecodeScan, scan_token
from groma_tpu_torch.eval.generate import parse_region_tokens  # noqa: F401
from groma_tpu_torch.eval.speculative import (Verifier,
                                              speculative_greedy_decode)
from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama import fresh_cache, make_kv_cache
from groma_tpu_torch.models.llama_quant import (W8A8_UNDER_TP, local_heads,
                                                make_quant_kv_cache,
                                                quant_llama_forward,
                                                quant_llama_logits,
                                                quantize_llama_params,
                                                w8a8_weights)
from groma_tpu_torch.parallel.tensor_parallel import host_collectives
from groma_tpu_torch.utils.graphs import CallGraph

# decode steps between two reads of the done mask: the engine's default
# burst (BatchEngine's chunk)
DONE_CHECK_STEPS = 8


def quantize_groma_llm(model: GromaModel, cfg: GromaConfig,
                       bits: int = 8) -> dict:
    """The LLM branch of a GromaModel -> the quantized tree (``bits`` 8, 4
    or 16, see ``quantize_llama_params``); embeddings and the small extra
    head are kept in bf16.  On a model cut for tensor parallelism
    (``mesh.cut_tp``: ``model.tp_group`` set) the whole tree is quantized
    from the whole weights, gathered over the group (a collective: every
    rank calls it), and this rank's tree is cut from it
    (``mesh.cut_quant_tree``)."""
    from groma_tpu_torch.parallel import mesh
    group = getattr(model, 'tp_group', None)
    plan = getattr(model, 'tp_plan', {})

    def whole(name, t):
        return mesh._full(t, plan.get(name), group) if group is not None \
            else t
    sd = {k: whole('llm.' + k, v) for k, v in model.llm.state_dict().items()}
    qp = quantize_llama_params(sd, cfg.llm, bits=bits)
    del sd
    qp['new_input_embs'] = whole('new_input_embs.weight',
                                 model.new_input_embs.weight).to(
                                     torch.bfloat16)
    qp['extra_lm_head'] = whole('extra_lm_head.weight',
                                model.extra_lm_head.weight).T.to(
                                    torch.bfloat16)
    if group is None:
        return qp
    return mesh.cut_quant_tree(qp, cfg.llm, group)


def tree_tp_group(model: GromaModel, qp: dict, w8a8_prefill: bool = False):
    """The tp group the LLM of ``model`` and ``qp`` computes over: the cut
    tree's (``mesh.cut_quant_tree``), or None.  A tp-cut model needs a
    cut tree (``quantize_groma_llm`` cuts one); a cut tree refuses the
    W8A8 prefill."""
    tp = qp.get('tp')
    if getattr(model, 'tp_group', None) is not None and tp is None:
        raise ValueError('a tp-cut model takes a tp-cut quantized tree: '
                         'quantize_groma_llm cuts one, mesh.cut_quant_tree '
                         'cuts a whole one')
    if tp is not None and w8a8_prefill:
        raise ValueError(W8A8_UNDER_TP)
    return None if tp is None else tp['group']


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
    want to check or report: decode_forwards (the verify forwards, with
    speculation), prefill_ms, decode_ms_per_token (host clock around
    synchronized device work), logits_finite (the prefill's and the decode
    scan's logits; with speculation the prefill's), first_logits (the
    prefill's, numpy), the tokens, selected_boxes and selected_mask, and
    prefill_mode ('captured' on the card, 'eager' on the CPU);
    ``spec_stats`` the last speculative generation's verify_calls,
    accepted (per call) and tokens_per_call."""

    def __init__(self, model: GromaModel, qp: dict, max_len: int = 2048,
                 kv_bits: int = 16, use_flash: bool = False,
                 w8a8_prefill: bool = False, spec_lookahead: int = 0,
                 spec_ngram: int = 2):
        if kv_bits not in (8, 16):
            raise ValueError('kv_bits must be 8 or 16')
        self.tp = tree_tp_group(model, qp, w8a8_prefill)
        self.model = model
        self.cfg = model.cfg
        self.qp = qp
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.use_flash = use_flash
        self.w8a8_prefill = w8a8_prefill
        # the W8A8 products' K-major weights (6.5 GB at 7B), made once here
        self.kmajor = w8a8_weights(qp) if w8a8_prefill else None
        self.spec_lookahead = spec_lookahead
        self.spec_ngram = spec_ngram
        self.device = qp['norm'].device
        self.last_stats = None
        self.spec_stats = None
        self._decode: Optional[DecodeScan] = None
        self._verifier: Optional[Verifier] = None
        # a gloo tp group's collectives run on the host: nothing captured
        self.host_tp = host_collectives(self.tp)
        self._prefills = CallGraph(eager=self.host_tp)

    def _make_cache(self, b: int) -> dict:
        make = make_quant_kv_cache if self.kv_bits == 8 else make_kv_cache
        return make(self.cfg.llm, b, self.max_len, device=self.device,
                    kv_heads=local_heads(self.qp, self.cfg.llm)[1])

    def verifier(self) -> Verifier:
        """The speculative verify step, made at the first call and kept."""
        if self._verifier is None:
            vocab = self.cfg.llm.vocab_size
            self._verifier = Verifier(
                self.qp, self.cfg.llm, self._make_cache(1),
                self.spec_lookahead,
                lambda qp, ids: quant_embed(qp, ids, vocab), quant_logits,
                eager=self.host_tp)
        return self._verifier

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.array(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=self.device)

    def _scan(self, b: int, eos_id: int) -> DecodeScan:
        """The DecodeScan of this call's batch size and EOS id, made anew
        when either changes."""
        key = (b, eos_id)
        if self._decode is None or self._decode.key != key:
            old, self._decode = self._decode, None
            # a cache of the same batch is kept (and with it the prefill's
            # graph, which writes it); the old step graph is freed first
            cache = old.kv if old is not None and old.key[0] == b \
                else None
            del old
            cfg, dev = self.cfg.llm, self.device

            def step(st):
                tok = scan_token(st, eos_id)
                hidden, _ = quant_llama_forward(
                    self.qp, cfg, quant_embed(self.qp, tok[:, None],
                                              cfg.vocab_size),
                    torch.ones((b, 1), dtype=torch.bool, device=dev),
                    st['next_pos'] + st['step'], st['cache'])
                logits = quant_logits(self.qp, hidden)[:, -1]
                st['logits'].copy_(logits)
                st['finite'].logical_and_(torch.isfinite(logits).all())
                st['step'].add_(1)
            self._decode = DecodeScan(key, cache or self._make_cache(b), step,
                                      eager=self.host_tp)
        return self._decode

    def _prefill(self, cache, images, input_ids, region_slot, base_valid,
                 refer_boxes, refer_valid):
        """JAX's jitted prefill, the body of the prefill graph: vision,
        surgery, the LLM prefill into ``cache`` and the first logits ->
        (logits (B, V) f32, next positions (B, 1), the selected boxes and
        mask).  It reads nothing back to the host."""
        fresh_cache(cache)      # a capture follows a warm-up that filled it
        emb, _, valid, vis = self.model.prepare_stream(
            images, input_ids, region_slot, base_valid,
            refer_boxes=refer_boxes, refer_valid=refer_valid,
            use_flash=self.use_flash)
        pos = (torch.cumsum(valid.to(torch.int64), -1) - 1).clamp(min=0)
        hidden, _ = quant_llama_forward(self.qp, self.cfg.llm, emb, valid,
                                        pos, cache, use_flash=self.use_flash,
                                        w8a8=self.w8a8_prefill,
                                        kmajor=self.kmajor)
        rows = torch.arange(pos.shape[0], device=pos.device)
        last = torch.argmax(pos, dim=-1)
        logits = quant_logits(self.qp, hidden[rows, last][:, None])[:, 0]
        return (logits, pos[rows, last][:, None] + 1,
                vis['selected_boxes'], vis['selected_mask'])

    @torch.no_grad()
    def generate(self, images, input_ids, region_slot, base_valid,
                 refer_boxes=None, refer_valid=None,
                 max_new_tokens: int = 32, eos_id: int = 2):
        images = self._tensor(images, torch.float32)
        input_ids = self._tensor(input_ids, torch.int64)
        region_slot = self._tensor(region_slot, torch.int64)
        base_valid = self._tensor(base_valid, torch.bool)
        b, s = input_ids.shape
        spec = self.spec_lookahead > 0
        if spec and b != 1:
            raise ValueError('speculative decoding is single-stream (B=1)')
        # the slots a decode writes: a last verify starts at most at slot
        # s + max_new_tokens - 2 and writes spec_lookahead + 1
        need = s + max_new_tokens - 1 + self.spec_lookahead
        if need > self.max_len:
            raise ValueError(
                f'max_new_tokens={max_new_tokens} does not fit the KV cache: '
                f'the {s}-token stream leaves {self.max_len - s} of '
                f'{self.max_len} slots for decode, and it may write '
                f'{need - s}')
        if refer_boxes is not None:
            refer_boxes = self._tensor(refer_boxes, torch.float32)
            refer_valid = self._tensor(refer_valid, torch.bool)

        if spec:
            holder = self.verifier()
        else:
            holder = self._scan(b, eos_id)
        self._sync()
        t0 = time.perf_counter()
        cache = holder.cache()
        logits, next_pos, boxes, mask = self._prefills.run(
            self._prefill, cache, images, input_ids, region_slot,
            base_valid, refer_boxes, refer_valid)
        cache['index'] = s          # a replay sets no host value
        first = logits.float().cpu().numpy()
        t1 = time.perf_counter()

        if spec:
            cur = int(first[0].argmax())
            holder.begin(cur, int(next_pos[0, 0]))
            ctx = [int(t) for t, v in zip(input_ids[0].tolist(),
                                          base_valid[0].tolist()) if v]
            row, self.spec_stats = speculative_greedy_decode(
                holder, cur, ctx, max_new_tokens, eos_id,
                self.spec_lookahead, self.spec_ngram)
            toks = np.asarray([row], np.int32)
            forwards = self.spec_stats['verify_calls']
            finite = bool(np.isfinite(first).all())
        else:
            state = holder.begin(logits, next_pos)
            forwards = 0
            while forwards < max_new_tokens - 1:
                burst = min(DONE_CHECK_STEPS, max_new_tokens - 1 - forwards)
                holder.graph.run(burst)
                forwards += burst
                if bool(state['done'].all()):
                    break
            scan_token(state, eos_id)
            # the one read-back of the tokens, with the finite flag
            back = torch.cat([state['toks'][:, :forwards + 1].flatten(),
                              state['finite'].view(1).long()]).cpu().numpy()
            toks = back[:-1].reshape(b, forwards + 1).astype(np.int32)
            finite = bool(back[-1])
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
        vis_np = {'selected_boxes': boxes.float().cpu().numpy(),
                  'selected_mask': mask.cpu().numpy()}
        self.last_stats = {
            'decode_forwards': forwards,
            'prefill_ms': (t1 - t0) * 1e3,
            'decode_ms_per_token': (t2 - t1) * 1e3
            / max(tokens.shape[1] - 1 if spec else forwards, 1),
            'logits_finite': finite,
            'first_logits': first,
            'tokens': tokens, **vis_np,
            'prefill_mode': self._prefills.mode,
            'decode_mode': 'eager: gloo tp group' if self.host_tp else
            'graph' if self.device.type == 'cuda' else 'eager'}
        return tokens, vis_np
