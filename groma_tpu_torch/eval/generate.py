"""Generation over ``GromaModel.prefill`` / ``decode_step``: the unquantized
path (counterpart of ``groma_tpu/eval/generate.py``).

Vision runs once, in the prefill; decode steps the cached LLaMA forward one
token at a time, greedy at temperature 0, otherwise sampled from
``logits / max(T, 1e-6)`` (Gumbel-max, the law of ``jax.random.categorical``)
with an explicit ``torch.Generator``: seeded 0 when none is given, as the
JAX generator's key is, though its draws are not JAX's.

The two decode loops of the JAX generator:
  * ``use_scan=True`` (the default, JAX's ``lax.scan``): exactly
    ``max_new_tokens`` tokens a row, a row that has emitted EOS emitting
    EOS from then on; nothing is read back from the device inside the
    loop, and the tokens are fetched once at the end, then each row is cut
    after its first EOS and the rows padded with EOS to the widest.  The
    scan body (sample, done mask, one ``decode_step`` at a device cache
    index, the token written at a device step counter) is a
    ``utils.graphs.StepGraph`` over a ``DecodeScan``'s static state, kept
    across calls of one batch size and EOS id (a sampled decode's also of
    one temperature and generator): on the card the first call runs one
    warm-up step and one capture, and every further step of it and of
    later calls is a replay, the sampler's generator registered with the
    graph; on the CPU the same step, eagerly;
  * ``use_scan=False`` (JAX's Python loop): the tokens are read back each
    step, and the loop stops once every row has emitted EOS; rows are not
    forced to EOS after their own, and not cut.

Both run no forward whose logits would go unused (JAX's do, after the
last token), so a decode of ``max_new_tokens`` needs ``max_new_tokens - 1``
free cache slots past the stream; one that would not fit raises ValueError
(the JAX cache write clamps).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama import make_kv_cache
from groma_tpu_torch.utils.graphs import StepGraph


class DecodeScan:
    """A generator's decode scan, kept across ``generate`` calls of one key
    as ``jax.jit`` keeps a compiled scan: the static state (a cache of
    ``max_len`` slots and its 0-d device index, the logits, next positions,
    done mask, tokens, step counter and finite flag) and the StepGraph of
    ``step(state)`` over it, captured at the key's first call and replayed
    by every later one.  ``cache()`` hands the cache to a prefill (mask
    cleared, index 0); ``begin`` loads the prefill's results into the
    state."""

    def __init__(self, key, cache: dict, step, generators=()):
        self.key = key
        self._cache = cache
        self._step = step
        self._generators = generators
        self.state = None
        self.graph = None

    def cache(self) -> dict:
        self._cache['mask'].zero_()
        self._cache['index'] = 0
        return self._cache

    def begin(self, logits, next_pos) -> dict:
        """After the prefill filled ``cache()``: its logits (B, V) and next
        positions (B, 1) into the state, done, step and the index reset."""
        s = self._cache['index']
        if self.state is None:
            dev = logits.device
            self._index = torch.full((), s, dtype=torch.int64, device=dev)
            self.state = {
                'logits': logits.clone(), 'cache': self._cache,
                'next_pos': next_pos.clone(),
                'done': torch.zeros(logits.shape[0], dtype=torch.bool,
                                    device=dev),
                'toks': torch.zeros((logits.shape[0],
                                     self._cache['mask'].shape[1]),
                                    dtype=torch.int64, device=dev),
                'step': torch.zeros((), dtype=torch.int64, device=dev),
                'finite': torch.isfinite(logits).all()}
            self.graph = StepGraph(self._step, self.state, self._generators)
        else:
            st = self.state
            self._index.fill_(s)
            st['logits'].copy_(logits)
            st['next_pos'].copy_(next_pos)
            st['done'].zero_()
            st['step'].zero_()
            st['finite'].copy_(torch.isfinite(logits).all())
        self._cache['index'] = self._index
        return self.state


def sample_tokens(logits, temperature: float, generator: torch.Generator):
    """Greedy at temperature 0, else one categorical draw a row from
    ``logits / max(T, 1e-6)`` by the Gumbel-max trick (no host sync)."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature <= 0.0:
        return greedy
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device, dtype=torch.float32)
    u = u.to(logits.device).clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / max(temperature, 1e-6) + gumbel,
                        dim=-1)


def scan_token(st, eos_id: int, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """A decode scan's token from its state's logits (greedy at temperature
    0), EOS on rows already done, written at the step counter."""
    tok = torch.where(st['done'], eos_id,
                      sample_tokens(st['logits'], temperature, generator))
    st['done'].logical_or_(tok == eos_id)
    st['toks'].index_copy_(1, st['step'].view(1), tok[:, None])
    return tok


class Generator:
    """Prefill + decode with the unquantized model (the LLM in
    ``cfg.llm.dtype``, a KV cache of ``max_len`` slots in it).
    ``use_flash`` takes the flash-attention kernels in the prefill: the
    ViT's bidirectional forward, and the LLM's causal one from
    ``FLASH_MIN_SEQ`` tokens on.

    After each ``generate`` call, ``last_stats`` holds: decode_forwards,
    prefill_ms, decode_ms_per_token (host clock around synchronized device
    work), logits_finite, the prefill's logits (first_logits, numpy f32),
    and the tokens, selected_boxes and selected_mask."""

    def __init__(self, model: GromaModel, max_len: int = 2048,
                 use_flash: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len
        self.use_flash = use_flash
        self.device = model.llm.model.embed_tokens.weight.device
        self.last_stats = None
        self._decode: Optional[DecodeScan] = None

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tensor(self, x, dtype):
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                               dtype=dtype, device=self.device)

    def _scan(self, b: int, temperature: float, generator, eos_id: int):
        """The DecodeScan of this call's key (batch, EOS id, and for a
        sampled decode its temperature and generator), made anew when the
        key changes."""
        sampled = temperature > 0
        key = (b, eos_id, temperature if sampled else 0.0,
               generator if sampled else None)
        if self._decode is None or self._decode.key != key:
            self._decode = None        # free the old graph and cache first

            def step(st):
                tok = scan_token(st, eos_id, temperature, generator)
                logits, _ = self.model.decode_step(
                    tok[:, None], st['cache'], st['next_pos'] + st['step'])
                st['logits'].copy_(logits)
                st['finite'].logical_and_(torch.isfinite(logits).all())
                st['step'].add_(1)
            self._decode = DecodeScan(
                key, make_kv_cache(self.cfg.llm, b, self.max_len,
                                   device=self.device), step,
                (generator,) if sampled and self.device.type == 'cuda'
                else ())
        return self._decode

    @torch.inference_mode()
    def generate(self, images, input_ids, region_slot, base_valid,
                 refer_boxes=None, refer_valid=None,
                 max_new_tokens: int = 32, eos_id: int = 2,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 use_scan: bool = True):
        """Greedy (temperature 0) or sampled decoding.  Returns (tokens
        (B, <= max_new_tokens) numpy int32, {'selected_boxes',
        'selected_mask'} numpy)."""
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
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        elif temperature > 0 and use_scan \
                and generator.device.type != self.device.type:
            raise ValueError(f'a {generator.device} generator for a model '
                             f'on {self.device}: the captured scan draws on '
                             f'the model\'s device')

        scan = self._scan(b, temperature, generator, eos_id) \
            if use_scan else None
        self._sync()
        t0 = time.perf_counter()
        logits, cache, vis, next_pos = self.model.prefill(
            images, input_ids, region_slot, base_valid, self.max_len,
            refer_boxes, refer_valid, use_flash=self.use_flash,
            cache=scan.cache() if use_scan else None)
        self._sync()
        t1 = time.perf_counter()

        first_logits = logits
        finite = torch.isfinite(logits).all()
        forwards = 0
        if use_scan:
            state = scan.begin(logits, next_pos)
            forwards = max_new_tokens - 1
            scan.graph.run(forwards)
            scan_token(state, eos_id, temperature, generator)
            # the one read-back: every token and the finite flag
            back = torch.cat([state['toks'][:, :max_new_tokens].flatten(),
                              state['finite'].view(1).long()]).cpu().numpy()
            toks = back[:-1].reshape(b, max_new_tokens).astype(np.int32)
            finite = bool(back[-1])
            rows = []
            for row in toks:
                stop = np.nonzero(row == eos_id)[0]
                rows.append(row[:stop[0] + 1] if len(stop) else row)
            tokens = np.full((b, max(len(r) for r in rows)), eos_id, np.int32)
            for i, r in enumerate(rows):
                tokens[i, :len(r)] = r
        else:
            out, done = [], np.zeros(b, bool)
            for i in range(max_new_tokens):
                tok = sample_tokens(logits, temperature, generator)
                tok_np = tok.cpu().numpy().astype(np.int32)
                out.append(tok_np)
                done |= tok_np == eos_id
                if done.all() or i == max_new_tokens - 1:
                    break
                logits, cache = self.model.decode_step(tok[:, None], cache,
                                                       next_pos + i)
                finite = finite & torch.isfinite(logits).all()
                forwards += 1
            tokens = np.stack(out, axis=1) if out \
                else np.zeros((b, 0), np.int32)
        self._sync()
        t2 = time.perf_counter()

        vis_np = {'selected_boxes':
                  vis['selected_boxes'].float().cpu().numpy(),
                  'selected_mask': vis['selected_mask'].cpu().numpy()}
        self.last_stats = {
            'decode_forwards': forwards,
            'prefill_ms': (t1 - t0) * 1e3,
            'decode_ms_per_token': (t2 - t1) * 1e3 / max(forwards, 1),
            'logits_finite': bool(finite),
            'first_logits': first_logits.float().cpu().numpy(),
            'tokens': tokens, **vis_np}
        return tokens, vis_np


def parse_region_tokens(tokens: np.ndarray, box_idx_start: int,
                        num_region_tokens: int = 100):
    """Extract the <rK> indices from generated tokens."""
    return [[int(t - box_idx_start) for t in row
             if box_idx_start <= t < box_idx_start + num_region_tokens]
            for row in tokens]
