"""Continuous-batching inference engine over fixed slots (counterpart of
``groma_tpu/serve/engine.py``).

The engine keeps ``max_slots`` independent streams in one batched KV
cache.  A new request is prefilled (vision, token surgery, LLM prefill)
into any free slot while the other slots keep decoding; each decode burst
runs ``chunk`` single-token steps over all slots, with per-row positions,
done flags and cache indices, and emits the tokens to the requests'
sessions.  The LLM side is a quantized tree (``quantize_groma_llm``: int8,
int4 or the bf16 ``bits=16`` tree), or, with ``qp=None``, the model's own
unquantized LLM: ``GromaModel.prefill`` at b=1 into a cache in
``cfg.llm.dtype``, then ``decode_step`` over the per-row cache indices.
Without ``qp`` the cache is ``kv_bits=16`` and contiguous, as in JAX.

KV storage: a contiguous per-slot cache (``kv_bits`` 16 or 8), or with
``paged_kv`` a shared pool of 128-token int8 pages (``ops.paged_attention``)
from which each slot takes pages as its stream grows; page 0 is the trash
page, the allocator never hands it out, and frozen rows write there.

As in JAX: one-shot b=1 admission, or ``admit_batch=K`` padded batched
admission; priority admission (FIFO within a priority); ``Session.cancel``;
per-request ``max_new_tokens``; per-slot temperature (greedy rows stay
exactly greedy), the first token sampled on the host from a numpy RNG and
the others on the device from a ``torch.Generator``, both seeded with
``sample_seed`` (their draws are not JAX's); ``stats()``; a fatal error in
the scheduler loop ends every live and queued stream by re-raising it.

Unlike JAX, an inactive or finished row does not advance its cache index
(JAX adds 1 to every row each step and drops the writes that fall past the
cache; here such a write would be out of range), and the prefill cache is
as long as the stream, not ``max_len``.

A decode burst is JAX's jitted scan of ``chunk`` steps: one step over
static device buffers (tokens, positions, done flags, the active mask,
temperatures, the cache index or the page table, the burst's token
columns and step counter, the finite flag), captured once as a
``utils.graphs.StepGraph`` and replayed ``chunk`` times, one graph for
greedy bursts and one for bursts with a sampled row (which draws from the
engine's generator, registered with the graph).  The host writes the
active mask, temperatures and page table into their buffers with one copy
each from pinned memory before a burst, and reads the tokens, positions,
done flags and finite flag back in one copy after it.  On the CPU the same
step runs eagerly.

``w8a8_prefill`` (int8 trees) runs the one-shot, batched and chunked
prefills' layer matmuls as int8 x int8 products, as JAX's does.

``prefill_chunk_tokens`` (quantized trees, contiguous cache): chunked
prefill.  Vision and token surgery run once, then the stream goes through
the LLM in (1, c) chunks appended at a scalar cache index, the trailing
all-pad chunks skipped, with a decode burst for the live slots between
chunks and between back-to-back admissions, so that a long prefill stalls
the live streams by one chunk at a time.  The chunk's forward is one
``StepGraph`` per engine over static (1, c) buffers and a b=1 chunk cache
whose index is a device word: eager on the CPU, one capture and replays on
the card.  Unlike JAX, whose b=1 chunk cache is ``max_len`` long and whose
``dynamic_update_slice`` moves a last chunk that would end past it back
over earlier keys, the chunk cache covers every whole chunk
(``max_len`` rounded up to a multiple of c) and only its first
``max_len`` slots are seated: the slots past the stream's last valid token
are mask-False padding.

``spec_lookahead`` = G (quantized trees, contiguous cache, greedy only):
JAX's speculative mode.  ``max_len`` grows by G (rounded up to 128), a
sampled request is refused, each session keeps its context (``_ctx``), and
``verifier(state)`` runs JAX's ``verify_chunk`` on a decode state
(``clone_state()``): one (B, G+1) forward through
the vector-index multi-token append, greedy acceptance, per-row counts and
an exact per-row rewind.  As in JAX, the scheduler loop never calls it:
the bursts stay sequential.

Unlike JAX, a request taken off the queue stays the engine's until it is
seated: if its prefill or seating raises, every unseated request of that
admission group ends with the error (its ``token_stream()`` re-raises)
before the engine dies, where JAX's would wait forever.
"""

from __future__ import annotations

import atexit
import itertools
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from groma_tpu_torch.eval.generate_quant import quant_embed, quant_logits
from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama import make_kv_cache, torch_dtype
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_decode_paged,
                                                quant_llama_forward,
                                                w8a8_weights)
from groma_tpu_torch.ops.paged_attention import (PAGE, insert_prefill_pages,
                                                 make_kv_page_pool)
from groma_tpu_torch.utils.graphs import StepGraph


class Session:
    """Per-request handle: consume ``token_stream()`` until exhaustion."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.vis = None            # the selected boxes and mask (numpy)
        self.tokens: list = []
        self.done = False
        self.cancelled = False     # client stop (e.g. a stop string hit)
        self.truncated = False     # paged mode: the page pool ran dry
        self.error = None          # the engine's fatal exception, if any
        self.t_submit = time.time()
        self.t_first: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first-token latency (None until the first token)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    def cancel(self):
        """Client-side early stop: the engine frees this slot at the next
        burst boundary; the stream ends after the in-flight burst."""
        self.cancelled = True

    def token_stream(self):
        """Yields token ids as they are produced; ends at EOS or the cap,
        or re-raises the engine's fatal error."""
        while True:
            item = self._q.get()
            if item is None:
                if self.error is not None:
                    raise RuntimeError(
                        'engine died mid-stream') from self.error
                return
            yield item


class BatchEngine:
    def __init__(self, model: GromaModel, qp: Optional[dict] = None,
                 max_slots: int = 4,
                 max_len: Optional[int] = None, eos_id: int = 2,
                 chunk: int = 8, max_new_tokens: int = 256,
                 kv_bits: int = 16,
                 prefill_chunk_tokens: Optional[int] = None,
                 admit_batch: int = 1, w8a8_prefill: bool = False,
                 paged_kv: bool = False,
                 kv_pool_tokens: Optional[int] = None,
                 sample_seed: int = 0, spec_lookahead: int = 0):
        """``qp``: a ``quantize_groma_llm`` tree, or None for the model's
        own unquantized LLM.  ``max_len`` (rounded up to a multiple of 128;
        default max_seq_len + max_new_tokens + 8) is each slot's cache
        length, or with ``paged_kv`` the per-request cap.  ``paged_kv``
        (int8 KV and MHA) shares a pool of ``kv_pool_tokens`` tokens
        (default max_slots x max_len); a request whose decode outruns the
        pool is truncated (``session.truncated``), and admission waits
        while fewer pages are free than one request could need.
        ``prefill_chunk_tokens``: chunked prefill in chunks of that many
        tokens; ``spec_lookahead``: the speculative mode (see the module's
        docstring).  Both need ``qp`` and exclude ``paged_kv``."""
        if prefill_chunk_tokens is not None and qp is None:
            raise ValueError('chunked prefill requires the quantized path')
        if prefill_chunk_tokens and paged_kv:
            raise ValueError('paged_kv excludes chunked prefill')
        if spec_lookahead > 0 and qp is None:
            raise ValueError('engine speculative decoding requires a '
                             'quantized/bf16 tree (qp)')
        if spec_lookahead > 0 and paged_kv:
            raise ValueError('speculative decoding excludes paged_kv')
        if kv_bits not in (8, 16):
            raise ValueError('kv_bits must be 8 or 16')
        if qp is None and (kv_bits != 16 or paged_kv):
            raise ValueError('the unquantized engine (qp=None) keeps a '
                             'contiguous kv_bits=16 cache')
        cfg = model.cfg
        self.model = model
        self.qp = qp
        self.cfg = cfg
        self.w8a8_prefill = w8a8_prefill
        # the W8A8 products' K-major weights, made here, before the pools
        # are sized and outside any request
        self.kmajor = (w8a8_weights(qp) if w8a8_prefill and qp is not None
                       else None)
        self.device = model.llm.model.embed_tokens.weight.device
        self.eos_id = eos_id
        self.chunk = chunk
        self.max_new_tokens = max_new_tokens
        self.max_slots = max_slots
        self.admit_batch = max(1, admit_batch)
        self._kv_bits = kv_bits
        max_len = max_len or cfg.max_seq_len + max_new_tokens + 8
        self.max_len = -(-max_len // 128) * 128
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.spec_lookahead = spec_lookahead
        if spec_lookahead > 0:
            # a verify writes G + 1 slots from a row's index: room for G
            # more past the cap (rounded up to 128, as JAX's)
            self.max_len = -(-(self.max_len + spec_lookahead) // 128) * 128
        self.paged = paged_kv
        dev = self.device
        if paged_kv:
            if kv_bits != 8:
                raise ValueError('paged_kv requires kv_bits=8')
            if cfg.llm.num_heads != cfg.llm.num_kv_heads:
                raise ValueError('paged_kv requires MHA')
            self._page = PAGE
            self._np_max = self.max_len // PAGE
            pool_tokens = kv_pool_tokens or max_slots * self.max_len
            self._num_pages = pool_tokens // PAGE + 1
            self._free_pages = list(range(self._num_pages - 1, 0, -1))
            self._slot_pages = [[] for _ in range(max_slots)]
            self._pools = make_kv_page_pool(cfg.llm, self._num_pages, dev)
            self._cache = None
        else:
            self._cache = self._fresh_cache(max_slots, self.max_len)
            self._cache['index'] = torch.zeros((max_slots,), dtype=torch.int64,
                                               device=dev)
        # the host's active mask, temperatures and page table: numpy views
        # of pinned buffers, copied into the step's before each burst
        pinned = dev.type == 'cuda'
        self._host = {
            'active': torch.zeros(max_slots, dtype=torch.bool,
                                  pin_memory=pinned),
            'temps': torch.zeros(max_slots, pin_memory=pinned),
            'table': torch.zeros((max_slots, self._np_max if paged_kv
                                  else 0), dtype=torch.int32,
                                 pin_memory=pinned)}
        self._active = self._host['active'].numpy()
        self._temps = self._host['temps'].numpy()
        self._table_np = self._host['table'].numpy()
        self._tok = torch.full((max_slots,), eos_id, dtype=torch.int64,
                               device=dev)
        self._pos = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self._done = torch.ones((max_slots,), dtype=torch.bool, device=dev)
        self._pos_np = np.zeros((max_slots,), np.int64)   # as of the last
        self._done_np = np.ones((max_slots,), bool)       # read-back
        self._state = {
            'tok': self._tok, 'pos': self._pos, 'done': self._done,
            **{k: v.to(dev) for k, v in self._host.items()},
            'out': torch.zeros((max_slots, chunk), dtype=torch.int64,
                               device=dev),
            'step': torch.zeros((), dtype=torch.int64, device=dev),
            'finite': torch.ones((), dtype=torch.bool, device=dev)}
        if paged_kv:
            self._state['pools'] = self._pools
        else:
            self._state['cache'] = self._cache
        self._graphs: dict = {}    # sampled -> the burst step's StepGraph
        self._chunk = None         # the chunked prefill's state and graph
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(sample_seed)
        self._host_rng = np.random.default_rng(sample_seed)
        self._sessions: list = [None] * max_slots
        self._emitted = np.zeros((max_slots,), np.int64)

        # entries (-priority, seq, payload): higher priority admits first
        self._queue: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self._n_submitted = 0
        self._n_finished = 0
        self._n_truncated = 0
        self._n_tokens = 0
        self._n_steps = 0          # decode steps (each advances every slot)
        self._decode_sec = 0.0     # wall time in decode bursts, read back
        self._n_nonfinite = 0      # prefills and bursts with non-finite logits
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._t_started = time.time()
        self._stop = False
        self._fatal: Optional[BaseException] = None
        # serializes submit() against _abort_all(), so that no request can
        # be enqueued after the abort drained the queue
        self._admission_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        atexit.register(self.close)

    def _fresh_cache(self, batch: int, length: int) -> dict:
        if self._kv_bits == 8:
            return make_quant_kv_cache(self.cfg.llm, batch, length,
                                       device=self.device)
        return make_kv_cache(self.cfg.llm, batch, length, device=self.device)

    # ------------------------------------------------------------- API

    def submit(self, image, input_ids, region_slot, base_valid,
               max_new_tokens: Optional[int] = None, priority: int = 0,
               temperature: float = 0.0) -> Session:
        """Enqueue one request (unbatched arrays); returns its Session.
        ``max_new_tokens`` caps this request (bounded by the engine's);
        higher ``priority`` admits first (seated requests are never
        preempted); ``temperature`` > 0 samples this stream."""
        sess = Session()
        sess.max_new = min(max_new_tokens or self.max_new_tokens,
                           self.max_new_tokens)
        sess.temperature = float(temperature)
        if self.spec_lookahead > 0:
            if sess.temperature > 0:
                raise ValueError('speculative decoding verifies greedily; '
                                 'temperature sampling is unsupported')
            sess._ctx = [int(t) for t, v in zip(
                np.asarray(input_ids).reshape(-1),
                np.asarray(base_valid).reshape(-1)) if v]
        with self._admission_lock:
            if self._fatal is not None:
                raise RuntimeError('engine is dead (fatal scheduler-loop '
                                   'error)') from self._fatal
            if self._stop:
                raise RuntimeError('engine is closed')
            self._n_submitted += 1
            self._queue.put((-priority, next(self._seq),
                             (sess, image, input_ids, region_slot,
                              base_valid)))
        return sess

    def stats(self) -> dict:
        """Admission and finish totals, occupancy, mean TTFT, aggregate
        tokens per second since start, decode steps and their mean wall
        time, prefills and bursts whose logits were not all finite, and
        (paged) the pool's headroom."""
        out = {
            'submitted': self._n_submitted,
            'finished': self._n_finished,
            'truncated': self._n_truncated,
            'active_slots': int(self._active.sum()),
            'max_slots': self.max_slots,
            'waiting': self._queue.qsize(),
            'tokens_emitted': self._n_tokens,
            'tokens_per_sec': round(
                self._n_tokens / max(time.time() - self._t_started, 1e-9),
                2),
            'mean_ttft_sec': round(self._ttft_sum / self._ttft_n, 4)
            if self._ttft_n else None,
            'decode_steps': self._n_steps,
            'decode_ms_per_step': round(1e3 * self._decode_sec
                                        / self._n_steps, 3)
            if self._n_steps else None,
            'nonfinite_logits': self._n_nonfinite,
        }
        if self.paged:
            out['free_pages'] = len(self._free_pages)
            out['total_pages'] = self._num_pages - 1
        if self._fatal is not None:
            out['fatal'] = f'{type(self._fatal).__name__}: {self._fatal}'
        return out

    def close(self):
        self._stop = True
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        # the exit hook held the engine, and with it its caches and graphs
        atexit.unregister(self.close)

    # ---------------------------------------------------------- prefill

    def _tensor(self, rows, dtype):
        return torch.as_tensor(np.stack([np.asarray(r) for r in rows]),
                               dtype=dtype, device=self.device)

    def _prefill(self, reqs):
        """Requests -> (first-token logits (B, V), prefill cache, vis,
        next positions (B,) on the host)."""
        images = self._tensor([r[1] for r in reqs], torch.float32)
        ids = self._tensor([r[2] for r in reqs], torch.int64)
        rslot = self._tensor([r[3] for r in reqs], torch.int64)
        valid = self._tensor([r[4] for r in reqs], torch.bool)
        if self.qp is None:
            logits, cache, vis, next_pos = self.model.prefill(
                images, ids, rslot, valid, max_len=ids.shape[1])
            next_pos = next_pos[:, 0].cpu().numpy()
            self._n_nonfinite += int(not torch.isfinite(logits).all())
            return logits, cache, vis, next_pos
        emb, _, valid, vis = self.model.prepare_stream(images, ids, rslot,
                                                       valid)
        pos = (torch.cumsum(valid.to(torch.int64), -1) - 1).clamp(min=0)
        cache = self._fresh_cache(len(reqs), emb.shape[1])
        hidden, cache = quant_llama_forward(self.qp, self.cfg.llm, emb,
                                            valid, pos, cache,
                                            w8a8=self.w8a8_prefill,
                                            kmajor=self.kmajor)
        rows = torch.arange(len(reqs), device=self.device)
        last = torch.argmax(pos, dim=-1)
        logits = quant_logits(self.qp, hidden[rows, last][:, None])[:, 0]
        next_pos = (pos[rows, last] + 1).cpu().numpy()
        self._n_nonfinite += int(not torch.isfinite(logits).all())
        return logits, cache, vis, next_pos

    def _chunk_step(self, st):
        """One (1, c) chunk appended to the chunk cache at its index."""
        hidden, _ = quant_llama_forward(
            self.qp, self.cfg.llm, st['emb'], st['valid'], st['pos'],
            st['cache'], chunked=True, w8a8=self.w8a8_prefill,
            kmajor=self.kmajor)
        st['hidden'].copy_(hidden)

    def _chunk_graph(self, emb) -> StepGraph:
        """The chunk step's StepGraph over its static state, made at the
        first chunked prefill: (1, c) buffers of embeddings, validity,
        positions and hidden states, and a b=1 cache of every whole chunk
        that ``max_len`` holds, its index a device word."""
        if self._chunk is None:
            c = self.prefill_chunk_tokens
            cache = self._fresh_cache(1, -(-self.max_len // c) * c)
            cache['index'] = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
            st = {'cache': cache,
                  'emb': emb.new_zeros((1, c, emb.shape[2])),
                  'valid': torch.zeros((1, c), dtype=torch.bool,
                                       device=self.device),
                  'pos': torch.zeros((1, c), dtype=torch.int64,
                                     device=self.device),
                  'hidden': emb.new_zeros((1, c, emb.shape[2]),
                                          dtype=torch_dtype(
                                              self.cfg.llm.dtype))}
            self._chunk = StepGraph(self._chunk_step, st)
        return self._chunk

    def _chunked_prefill(self, req):
        """One request -> ``_prefill``'s outputs: vision and surgery once,
        then the LLM in chunks of ``prefill_chunk_tokens``, a decode burst
        for the live slots between chunks."""
        c = self.prefill_chunk_tokens
        images = self._tensor([req[1]], torch.float32)
        ids = self._tensor([req[2]], torch.int64)
        rslot = self._tensor([req[3]], torch.int64)
        valid = self._tensor([req[4]], torch.bool)
        emb, _, valid, vis = self.model.prepare_stream(images, ids, rslot,
                                                       valid)
        pos = (torch.cumsum(valid.to(torch.int64), -1) - 1).clamp(min=0)
        valid_np = valid[0].cpu().numpy()
        last_idx = int(np.nonzero(valid_np)[0][-1])
        n_chunks = last_idx // c + 1    # trailing all-pad chunks skipped
        pad = n_chunks * c - emb.shape[1]
        if pad > 0:
            emb = F.pad(emb, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
            pos = F.pad(pos, (0, pad))
        graph = self._chunk_graph(emb)
        st = graph.state
        if n_chunks * c > st['cache']['mask'].shape[1]:
            raise ValueError(f'the stream\'s last valid token ({last_idx}) '
                             f'lies past max_len ({self.max_len})')
        st['cache']['mask'].zero_()
        st['cache']['index'].zero_()
        for ci in range(n_chunks):
            lo = ci * c
            st['emb'].copy_(emb[:, lo:lo + c])
            st['valid'].copy_(valid[:, lo:lo + c])
            st['pos'].copy_(pos[:, lo:lo + c])
            graph.run(1)
            if ci + 1 < n_chunks and self._active.any():
                self._decode_burst()     # keep the live streams moving
        local = last_idx - (n_chunks - 1) * c
        logits = quant_logits(self.qp, st['hidden'][:, local:local + 1])[:, 0]
        self._n_nonfinite += int(not torch.isfinite(logits).all())
        # decode writes at last_idx + 1, not at the chunks' end: the slots
        # between are mask-False padding; the first max_len slots seat
        cache, n = st['cache'], self.max_len
        one = {key: [t[:, :, :n] for t in cache[key]]
               for key in ('k', 'v', 'k_scale', 'v_scale') if key in cache}
        one['mask'] = cache['mask'][:, :n]
        one['index'] = last_idx + 1
        next_pos = np.asarray([int(valid_np.sum())])
        return logits, one, vis, next_pos

    def _admit(self):
        while not self._queue.empty():
            free = [i for i in range(self.max_slots) if not self._active[i]]
            if not free:
                return
            if self.paged and len(self._free_pages) < self._np_max:
                # back-pressure: a prompt may need up to np_max pages and
                # the decoding slots top up from the same pool
                return
            group = []
            while len(group) < min(self.admit_batch, len(free)):
                try:
                    req = self._queue.get_nowait()[2]
                except queue.Empty:
                    break
                if req[0].cancelled:          # cancelled while waiting
                    req[0].done = True
                    req[0]._q.put(None)
                    continue
                group.append(req)
            if not group:
                return
            # taken off the queue, the group is the engine's until seated:
            # a prefill or seat that raises ends each unseated stream
            unseated = [req[0] for req in group]
            try:
                if len(group) >= 2 and self.admit_batch > 1 \
                        and not self.prefill_chunk_tokens:
                    # one padded b=K prefill: the last request is
                    # repeated, the pad rows are computed and never seated
                    padded = group + [group[-1]] * (self.admit_batch
                                                    - len(group))
                    logits, one, vis, next_pos = self._prefill(padded)
                    for row, req in enumerate(group):
                        self._seat(free[row], req[0], logits[row], one, row,
                                   vis, int(next_pos[row]))
                        unseated.remove(req[0])
                else:
                    for slot, req in zip(free, group):
                        if self.prefill_chunk_tokens:
                            logits, one, vis, next_pos = \
                                self._chunked_prefill(req)
                        else:
                            logits, one, vis, next_pos = self._prefill([req])
                        self._seat(slot, req[0], logits[0], one, 0, vis,
                                   int(next_pos[0]))
                        unseated.remove(req[0])
                        if self.prefill_chunk_tokens \
                                and not self._queue.empty() \
                                and self._active.any():
                            # back-to-back admissions: the live streams
                            # move between them too
                            self._decode_burst()
            except BaseException as e:
                for sess in unseated:
                    self._end(sess, e)
                raise

    def _seat(self, slot, sess, row_logits, one, row, vis, next_pos):
        """Install row ``row`` of a prefill into ``slot`` and emit its
        first token."""
        temp = sess.temperature
        if temp > 0:
            # sampled on the host with the in-burst law, logits / temp
            lg = row_logits.double().cpu().numpy() / temp
            lg -= lg.max()
            pz = np.exp(lg)
            pz /= pz.sum()
            tok0 = int(self._host_rng.choice(len(pz), p=pz))
        else:
            tok0 = int(torch.argmax(row_logits))
        sess.vis = {'selected_boxes':
                    vis['selected_boxes'][row].float().cpu().numpy(),
                    'selected_mask': vis['selected_mask'][row].cpu().numpy()}
        if self.paged:
            # exactly the pages the compacted stream occupies; the unused
            # page ids of the prefill point at the trash page
            need = -(-next_pos // self._page)
            if len(self._free_pages) < need:
                sess.truncated = sess.done = True
                sess._q.put(None)
                return
            pages = [self._free_pages.pop() for _ in range(need)]
            self._slot_pages[slot] = pages
            self._table_np[slot, :need] = pages
            self._table_np[slot, need:] = pages[-1]   # repeat-last tail
            ids = torch.zeros((one['mask'].shape[1] // PAGE,),
                              dtype=torch.int64)
            ids[:need] = torch.as_tensor(pages)
            insert_prefill_pages(self._pools, one, row, ids.to(self.device),
                                 valid=one['mask'][row])
        else:
            c = self._cache
            s = one['mask'].shape[1]
            for key in ('k', 'v', 'k_scale', 'v_scale'):
                for dst, src in zip(c.get(key, ()), one.get(key, ())):
                    dst[slot, :, :s] = src[row]
            c['mask'][slot, :s] = one['mask'][row]
            c['mask'][slot, s:] = False
            c['index'][slot] = one['index']
        self._temps[slot] = temp
        self._tok[slot] = tok0
        self._pos[slot] = next_pos
        self._done[slot] = tok0 == self.eos_id
        self._pos_np[slot] = next_pos
        self._done_np[slot] = tok0 == self.eos_id
        self._active[slot] = True
        self._emitted[slot] = 1
        self._sessions[slot] = sess
        if self.spec_lookahead > 0:
            sess._ctx.append(tok0)
        sess.t_first = time.time()
        self._ttft_sum += sess.t_first - sess.t_submit
        self._ttft_n += 1
        self._n_tokens += 1
        sess.tokens.append(tok0)
        sess._q.put(tok0)
        if tok0 == self.eos_id:
            self._finish(slot)

    # ----------------------------------------------------------- decode

    def _finish(self, slot, truncated: bool = False):
        sess = self._sessions[slot]
        if sess is not None:
            sess.truncated = sess.truncated or truncated
            sess.done = True
            sess._q.put(None)
            self._n_finished += 1
            if sess.truncated:
                self._n_truncated += 1
        self._sessions[slot] = None
        self._active[slot] = False
        self._temps[slot] = 0.0
        if self.paged:
            # the slot's pages go back to the pool, and its frozen decode
            # writes go to the trash page from now on
            self._free_pages.extend(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._table_np[slot, :] = 0

    def _topup_pages(self):
        """Give every live slot the pages for ``chunk`` more tokens; a slot
        the pool or the per-request cap cannot cover is truncated before
        the burst."""
        for slot in range(self.max_slots):
            if not self._active[slot] or self._done_np[slot]:
                continue
            end = int(self._pos_np[slot]) + self.chunk + 1
            if end > self._np_max * self._page:
                self._finish(slot, truncated=True)
                continue
            pages = self._slot_pages[slot]
            while len(pages) < -(-end // self._page):
                if not self._free_pages:
                    self._finish(slot, truncated=True)
                    break
                pages.append(self._free_pages.pop())
                self._table_np[slot, len(pages) - 1] = pages[-1]
            if self._active[slot] and pages:
                self._table_np[slot, len(pages):] = pages[-1]

    def _pick(self, logits, temps, sample: bool):
        greedy = torch.argmax(logits, dim=-1)
        if not sample:
            return greedy
        probs = torch.softmax(logits.float() / temps.clamp(min=1e-6)[:, None],
                              dim=-1)
        # torch.multinomial(probs, 1)'s draw (the exponential race), written
        # out: multinomial checks its input on the host, which no captured
        # step may do
        race = torch.empty_like(probs).exponential_(1, generator=self._gen)
        sampled = torch.argmax(probs / race, dim=-1)
        return torch.where(temps > 0, sampled, greedy)

    def _step(self, st, sample: bool):
        """One decode step over every slot, on the burst's static state;
        the token goes into column ``step`` of ``out``."""
        llm = self.cfg.llm
        tok, pos, done, active = st['tok'], st['pos'], st['done'], \
            st['active']
        live = active & ~done
        if self.paged:
            emb = quant_embed(self.qp, tok[:, None], llm.vocab_size)
            lengths = torch.where(live, pos + 1, 0).to(torch.int32)
            hidden, _ = quant_llama_decode_paged(
                self.qp, llm, emb, pos[:, None], st['pools'], st['table'],
                lengths)
            logits = quant_logits(self.qp, hidden)[:, -1]
        else:
            cache = st['cache']
            if self.qp is None:
                # frozen rows carry eos_id, which may be -1 ("never stop"):
                # the embedding table takes no negative id
                logits, _ = self.model.decode_step(tok.clamp(min=0)[:, None],
                                                   cache, pos[:, None])
            else:
                emb = quant_embed(self.qp, tok[:, None], llm.vocab_size)
                hidden, _ = quant_llama_forward(
                    self.qp, llm, emb, torch.ones_like(live[:, None]),
                    pos[:, None], cache)
                logits = quant_logits(self.qp, hidden)[:, -1]
            # the forward advanced every row's index; frozen rows step
            # back, so their writes stay inside the cache however long
            # they idle
            cache['index'].sub_((~live).long())
        st['finite'].logical_and_(torch.isfinite(logits).all())
        new = torch.where(live, self._pick(logits, st['temps'], sample),
                          self.eos_id)
        now_done = done | (new == self.eos_id) | ~active
        pos.add_((active & ~now_done).long())
        done.copy_(now_done)
        tok.copy_(new)
        st['out'].index_copy_(1, st['step'].view(1), new[:, None])
        st['step'].add_(1)

    # ------------------------------------------------------ speculation

    def _verify_step(self, st):
        """JAX's ``verify_chunk`` on a decode state ``st`` in place: the
        (B, G+1) tokens [tok, drafts] appended at each row's cache index,
        greedy acceptance of each row's longest agreeing draft prefix,
        ``emitted`` (the accepted greedy tokens, EOS past them and on rows
        not live) and ``counts`` (n_accept + 1, cut after an EOS inside
        the accepted run, 0 on rows not live), then each row's rewind: the
        mask cleared on the written slots past ``keep`` (index0 + 1 +
        n_accept on live rows, index0 on the others), the index set to
        ``keep``, and ``tok`` / ``pos`` / ``done`` advanced."""
        llm, G, eos = self.cfg.llm, self.spec_lookahead, self.eos_id
        tok0, pos0, done0, active = st['tok'], st['pos'], st['done'], \
            st['active']
        cache = st['cache']
        dev = tok0.device
        nb = tok0.shape[0]
        steps = torch.arange(G + 1, device=dev)
        toks = torch.cat([tok0[:, None], st['drafts']], dim=1)
        index0 = cache['index'].clone()
        hidden, _ = quant_llama_forward(
            self.qp, llm, quant_embed(self.qp, toks, llm.vocab_size),
            torch.ones((nb, G + 1), dtype=torch.bool, device=dev),
            pos0[:, None] + steps[None], cache, chunked=True)
        greedy = torch.argmax(quant_logits(self.qp, hidden), dim=-1)
        live = active & ~done0
        match = (greedy[:, :-1] == st['drafts']).long()
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        accepted = steps[None] <= n_acc[:, None]
        emitted = torch.where(accepted & live[:, None], greedy, eos)
        # an EOS inside the accepted run ends the row there
        is_eos = (greedy == eos) & accepted
        first_eos = torch.argmax(is_eos.long(), dim=1)
        has_eos = is_eos.any(dim=1) & live
        counts = torch.where(live, n_acc + 1, 0)
        counts = torch.where(has_eos, torch.minimum(counts, first_eos + 1),
                             counts)
        keep = index0 + torch.where(live, 1 + n_acc, 0)
        slots = torch.arange(cache['mask'].shape[1], device=dev)[None]
        cache['mask'].logical_and_(~((slots >= keep[:, None])
                                     & (slots < index0[:, None] + G + 1)))
        cache['index'].copy_(keep)
        tok0.copy_(torch.where(live, greedy.gather(1, n_acc[:, None])[:, 0],
                               tok0))
        pos0.copy_(torch.where(live, pos0 + n_acc + 1, pos0))
        done0.copy_(done0 | has_eos | ~active)
        st['emitted'].copy_(emitted)
        st['counts'].copy_(counts)

    def verifier(self, state: dict) -> 'Verify':
        """The verify step (``_verify_step``) over ``state``, a decode
        state such as ``clone_state()`` gives (the loop never verifies, as
        in JAX)."""
        if self.spec_lookahead <= 0:
            raise ValueError('the engine was built without spec_lookahead')
        return Verify(self, state)

    def clone_state(self) -> dict:
        """A copy of the decode state as of the last burst: the tensors of
        the burst's state (the cache, tokens, positions, done flags, the
        burst's buffers), the active mask the host's."""
        def clone(tree):
            if torch.is_tensor(tree):
                return tree.clone()
            if isinstance(tree, dict):
                return {k: clone(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [clone(v) for v in tree]
            return tree
        out = clone(self._state)
        out['active'].copy_(self._host['active'])
        return out

    def _decode_burst(self):
        """``chunk`` decode steps over all slots, then the emitted tokens go
        to their sessions."""
        if self.paged:
            self._topup_pages()
        if not self._active.any():
            return
        t0 = time.perf_counter()
        st = self._state
        for key, host in self._host.items():
            # pinned -> device; the host writes these arrays again only
            # after the burst's read-back, which waits for the copy
            st[key].copy_(host, non_blocking=True)
        st['step'].zero_()
        st['finite'].fill_(True)
        sample = bool((self._temps > 0).any())
        graph = self._graphs.get(sample)
        if graph is None:
            graph = self._graphs[sample] = StepGraph(
                lambda state: self._step(state, sample), st,
                generators=(self._gen,) if sample
                and self.device.type == 'cuda' else ())
        graph.run(self.chunk)
        # the burst's one read-back: tokens, positions, done, finite
        back = torch.cat([st['out'], st['pos'][:, None],
                          st['done'][:, None].long(),
                          st['finite'].long().expand(self.max_slots, 1)],
                         dim=1).cpu().numpy()
        self._pos_np[:] = back[:, self.chunk]
        self._done_np[:] = back[:, self.chunk + 1] != 0
        self._n_nonfinite += int(not back[0, self.chunk + 2])
        self._n_steps += self.chunk
        self._decode_sec += time.perf_counter() - t0
        self._emit(back[:, :self.chunk])

    def _emit(self, out_np):
        done_np = self._done_np
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            sess = self._sessions[slot]
            hit_eos = False
            for t in out_np[slot]:
                t = int(t)
                sess.tokens.append(t)
                sess._q.put(t)
                if self.spec_lookahead > 0:
                    sess._ctx.append(t)
                self._emitted[slot] += 1
                self._n_tokens += 1
                hit_eos = t == self.eos_id
                if hit_eos or self._emitted[slot] >= sess.max_new:
                    break
            if hit_eos or done_np[slot] or sess.cancelled \
                    or self._emitted[slot] >= sess.max_new:
                self._finish(slot)

    def _loop(self):
        # grad mode is thread-local: without this, the vision prefill on
        # this thread would record autograd graphs
        with torch.inference_mode():
            try:
                while not self._stop:
                    self._admit()
                    if not self._active.any():
                        time.sleep(0.002)
                        continue
                    self._decode_burst()
            except BaseException as e:  # noqa: BLE001 - fail fast, not hang
                with self._admission_lock:
                    self._fatal = e
                self._abort_all(e)
            else:
                with self._admission_lock:
                    pass     # no submit() can now slip past the drain
                self._drain_waiting(None)

    @staticmethod
    def _end(sess: Session, err: Optional[BaseException]):
        """End a stream, with the engine's error attached if any."""
        if err is not None:
            sess.error = err
        sess.done = True
        sess._q.put(None)

    def _drain_waiting(self, err: Optional[BaseException]):
        while not self._queue.empty():
            try:
                _, _, (sess, *_rest) = self._queue.get_nowait()
            except queue.Empty:
                break
            self._end(sess, err)

    def _abort_all(self, err: BaseException):
        """End every live and queued stream with the error attached."""
        for slot in range(self.max_slots):
            if self._active[slot]:
                self._active[slot] = False
                self._end(self._sessions[slot], err)
        self._drain_waiting(err)


class Verify:
    """The engine's verify step over one decode state (``tok``, ``pos``,
    ``done``, ``active``, ``cache`` with a (B,) index), to which it adds
    ``drafts`` (B, G), ``emitted`` (B, G+1) and ``counts`` (B,): a
    ``StepGraph``, eager on the CPU and captured on the card.  A call
    writes the drafts, checks on the host that every row's G + 1 writes
    stay inside the cache (a CUDA scatter out of range is a device
    assert, where JAX drops the write), runs one step and reads back
    (emitted, counts) as numpy arrays."""

    def __init__(self, engine: BatchEngine, state: dict):
        nb, G = state['tok'].shape[0], engine.spec_lookahead
        dev = state['tok'].device
        state.setdefault('drafts', torch.zeros((nb, G), dtype=torch.int64,
                                               device=dev))
        state.setdefault('emitted', torch.zeros((nb, G + 1),
                                                dtype=torch.int64,
                                                device=dev))
        state.setdefault('counts', torch.zeros(nb, dtype=torch.int64,
                                               device=dev))
        self.state, self.G = state, G
        self.graph = StepGraph(engine._verify_step, state)

    def __call__(self, drafts):
        st = self.state
        end = st['cache']['index'].max().item() + self.G + 1
        if end > st['cache']['mask'].shape[1]:
            raise ValueError(f'a verify would write up to slot {end - 1} '
                             f'of a {st["cache"]["mask"].shape[1]}-slot '
                             f'cache')
        st['drafts'].copy_(torch.as_tensor(np.asarray(drafts),
                                           dtype=torch.int64))
        with torch.no_grad():
            self.graph.run(1)
        back = torch.cat([st['emitted'], st['counts'][:, None]],
                         dim=1).cpu().numpy()
        return back[:, :-1], back[:, -1]
